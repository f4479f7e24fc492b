"""Regression evaluation CLI:

    python -m deep_kernel_transfer_tpu_torch.test_regression --method=DKT \
        --spectral --n_support=5 --n_test_epochs=10

Port of the JAX package's test_regression.py (reference
test_regression.py): each test epoch draws a random test person and
trajectory, conditions on n_support of its 19 points and takes the MSE
over all 19 (reference methods/DKT_regression.py:66-97); prints the mean
and std over n_test_epochs. transfer takes one Adam step on the support
from a fresh optimizer state, as the JAX CLI does. Reads best_model.tar
in the reference layout or the JAX package's npz. Runs on CUDA;
`main(argv, device="cpu")` runs on the CPU.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import factory
from .data.qmul import get_batch, test_people
from .io_utils import parse_args_regression
from .train_regression import IMAGE_SIZE, init_regression_method
from .utils.checkpoint import load_checkpoint


def evaluate(model, seed: int, n_support: int = 5,
             n_test_epochs: int = 10) -> tuple[float, float]:
    """(mean, std) over n_test_epochs of the MSE over all 19 points of a
    random test person's trajectory, conditioned on n_support of them;
    the draws come from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    mses = []
    for _ in range(n_test_epochs):
        person = [test_people[rng.randint(len(test_people))]]
        x, y = get_batch(person, rng)
        x = torch.from_numpy(x[0]).to(model.device)  # [19, H, W, C]
        y = torch.from_numpy(y[0]).to(model.device)
        idx = torch.from_numpy(rng.choice(19, n_support,
                                          replace=False)).to(model.device)
        mses.append(model.test_mse(x[idx], y[idx], x, y))
    return float(np.mean(mses)), float(np.std(mses))


def main(argv=None, device=None):
    params = parse_args_regression("test_regression", argv)
    np.random.seed(params.seed)
    model = init_regression_method(params, device)

    ckpt = os.path.join(factory.regression_checkpoint_dir(params),
                        "best_model.tar")
    load_checkpoint(ckpt, model, IMAGE_SIZE)
    print(f"loaded {ckpt}")

    mean, std = evaluate(model, params.seed, params.n_support,
                         params.n_test_epochs)
    print("-------------------")
    print(f"Average MSE: {mean:.4f} +- {std:.4f}")
    print("-------------------")
    return mean, std


if __name__ == "__main__":
    main()
