"""Regression training CLI:

    python -m deep_kernel_transfer_tpu_torch.train_regression --method=DKT \
        --spectral --stop_epoch=100

Port of the JAX package's train_regression.py (reference
train_regression.py): QMUL head-pose trajectories, Conv3 features and an
exact GP (DKT, rbf or --spectral) or a Linear head (transfer). Each epoch
draws one trajectory for the 24 training people from
RandomState(seed * 100003 + epoch), so a resumed run sees the data an
uninterrupted one would. --task_batch=1 (the default) takes one optimizer
step a person, in order, as the reference does; any other value takes ONE
step on the mean over all 24 people (the JAX package's rule, kept).
best_model.tar is written every 50 epochs and at the last, in the
reference's regression layout. Runs on CUDA; `main(argv, device="cpu")`
runs on the CPU.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import factory
from ._device import resolve_device
from .data.qmul import get_batch, train_people
from .io_utils import parse_args_regression
from .methods import DKTRegression, FeatureTransfer
from .models.backbones import feat_dims, model_dict
from .utils.checkpoint import load_checkpoint, save_checkpoint

IMAGE_SIZE = 100


def build_regression_method(params, device=None):
    """DKTRegression (rbf, or spectral with --spectral) or FeatureTransfer
    over the --model trunk (reference train_regression.py:24-34)."""
    backbone = model_dict[params.model]()
    if params.method == "DKT":
        kernel = "spectral" if params.spectral else "rbf"
        return DKTRegression(backbone, feat_dim=feat_dims[params.model],
                             kernel_type=kernel, device=device)
    if params.method == "transfer":
        return FeatureTransfer(backbone, device=device)
    raise ValueError(f"Unknown regression method {params.method}")


def init_regression_method(params, device=None):
    """The method of the command line, initialised from a generator seeded
    with --seed, on `device`."""
    model = build_regression_method(params, resolve_device(device))
    example = torch.zeros((19, IMAGE_SIZE, IMAGE_SIZE, 3))
    return model.init(example, torch.Generator().manual_seed(params.seed))


def main(argv=None, device=None):
    params = parse_args_regression("train_regression", argv)
    np.random.seed(params.seed)
    model = init_regression_method(params, device)

    ckpt_dir = factory.regression_checkpoint_dir(params)
    os.makedirs(ckpt_dir, exist_ok=True)
    print(f"checkpoint dir: {ckpt_dir}")
    ckpt = os.path.join(ckpt_dir, "best_model.tar")

    start_epoch = params.start_epoch
    if params.resume and os.path.isfile(ckpt):
        epoch = load_checkpoint(ckpt, model, IMAGE_SIZE)
        start_epoch = epoch + 1
        print(f"resumed from {ckpt} (epoch {epoch})")

    sequential = params.task_batch == 1 and hasattr(model,
                                                    "unbatched_train_step")
    for epoch in range(start_epoch, params.stop_epoch):
        rng = np.random.RandomState(params.seed * 100003 + epoch)
        xb, yb = get_batch(train_people, rng)
        xb = torch.from_numpy(xb).to(model.device)
        yb = torch.from_numpy(yb).to(model.device)
        if sequential:
            m = model.unbatched_train_step(xb, yb)
        else:
            m = model.train_step(xb, yb)
        print(f"[{epoch:03d}] loss: {float(m['loss']):.4f}")
        if epoch % 50 == 49 or epoch == params.stop_epoch - 1:
            save_checkpoint(ckpt, model, epoch)
    if start_epoch < params.stop_epoch:
        print(f"saved {ckpt}")
    else:
        print("nothing to train (start_epoch >= stop_epoch); checkpoint "
              "untouched")
    return model


if __name__ == "__main__":
    main()
