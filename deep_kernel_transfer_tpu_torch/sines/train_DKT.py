"""Sines DKT: MLP(1->40->40) features and a SpectralMixture(4, ard 40)
exact GP.

    python -m deep_kernel_transfer_tpu_torch.sines.train_DKT --task_batch=8

Port of sines_tpu/train_DKT.py (reference sines/train_DKT.py:113-277):
Adam 1e-3 on the GP and the net, -MLL of --task_batch tasks of 10 noisy
points a step; then 500 tasks, each conditioned on 5 points, MSE over its
195 query points; --n_plots saves confidence-region figures. `main(argv,
device)` returns the test MSEs; device="cpu" runs on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..methods import DKTRegression
from ..models.backbones import MLP2
from . import common


def main(argv=None, device=None):
    args = common.parse_args("train_DKT", default_iters=50000, argv=argv)
    rng = np.random.RandomState(args.seed)
    tasks = common.train_tasks()

    model = DKTRegression(MLP2(), feat_dim=40, kernel_type="spectral",
                          lr=1e-3, device=device)
    model.init(torch.zeros((10, 1)),
               torch.Generator().manual_seed(args.seed))
    dev = model.device

    for it in range(args.iterations):
        xb, yb = tasks.sample_batch(rng, args.task_batch,
                                    common.N_SHOT_TRAIN, noise=0.1)
        m = model.train_step(torch.from_numpy(xb).to(dev),
                             torch.from_numpy(yb).to(dev))
        if it % 100 == 0:
            print(f"[{it}] - Loss: {float(m['loss']):.3f}  "
                  f"noise: {float(m['noise']):.3f}")

    print("Test, please wait...")
    tt = common.test_tasks(args.out_of_range)
    mses = []
    for _ in range(args.n_test_tasks):
        _, xs, ys, xq, yq, _, _ = common.sample_eval_task(rng, tt)
        mses.append(model.test_mse(*(torch.from_numpy(a).to(dev)
                                     for a in (xs, ys, xq, yq))))
    common.report("DKT", mses)

    test_hi = 10.0 if args.out_of_range else 5.0
    for i in range(args.n_plots):
        task, xs, ys, _, _, x_all, _ = common.sample_eval_task(rng, tt)
        pred = model.predict(*(torch.from_numpy(a).to(dev)
                               for a in (xs, ys, x_all)))
        lower, upper = pred.confidence_region()
        common.save_uncertainty_plot(
            i, "DKT", task, xs, ys, x_all, pred.mean.cpu().numpy(),
            lower.cpu().numpy(), upper.cpu().numpy(), test_hi)
    return mses


if __name__ == "__main__":
    main()
