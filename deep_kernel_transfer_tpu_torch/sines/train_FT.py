"""Sines feature-transfer baseline: MLP(1->40->40) and Linear(40, 1).

    python -m deep_kernel_transfer_tpu_torch.sines.train_FT

Port of sines_tpu/train_FT.py (reference sines/train_FT.py): MSE training
over tasks (Adam 1e-3, 10 points a task), then, for each of 500 test
tasks, a copy finetuned for 100 steps of a fresh Adam(1e-2) on its 5
support points (reference train_FT.py:145-216); MSE over the query
points. `main(argv, device)` returns the test MSEs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..methods import FeatureTransfer
from ..models.backbones import MLP2
from . import common


def main(argv=None, device=None):
    args = common.parse_args("train_FT", default_iters=50000, argv=argv)
    rng = np.random.RandomState(args.seed)
    tasks = common.train_tasks()

    model = FeatureTransfer(MLP2(), lr=1e-3, device=device)
    model.init(torch.zeros((10, 1)),
               torch.Generator().manual_seed(args.seed))
    dev = model.device

    for it in range(args.iterations):
        xb, yb = tasks.sample_batch(rng, args.task_batch,
                                    common.N_SHOT_TRAIN, noise=0.1)
        m = model.train_step(torch.from_numpy(xb).to(dev),
                             torch.from_numpy(yb).to(dev))
        if it % 100 == 0:
            print(f"[{it}] - Loss: {float(m['loss']):.3f}")

    print("Test, please wait...")
    tt = common.test_tasks(args.out_of_range)
    mses = []
    for _ in range(args.n_test_tasks):
        _, xs, ys, xq, yq, _, _ = common.sample_eval_task(rng, tt)
        xs, ys, xq, yq = (torch.from_numpy(a).to(dev)
                          for a in (xs, ys, xq, yq))
        pred = model.finetune_and_predict((xs, ys), xq, steps=100, lr=1e-2)
        mses.append(float(torch.mean((pred - yq) ** 2)))
    common.report("FT", mses)

    test_hi = 10.0 if args.out_of_range else 5.0
    for i in range(args.n_plots):
        task, xs, ys, _, _, x_all, _ = common.sample_eval_task(rng, tt)
        pred = model.finetune_and_predict(
            (torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)),
            torch.from_numpy(x_all).to(dev), steps=100, lr=1e-2)
        common.save_uncertainty_plot(i, "FT", task, xs, ys, x_all,
                                     pred.cpu().numpy(), test_hi=test_hi)
    return mses


if __name__ == "__main__":
    main()
