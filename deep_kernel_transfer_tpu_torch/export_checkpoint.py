"""Export a checkpoint to the reference's torch layout:

    python -m deep_kernel_transfer_tpu_torch.export_checkpoint \\
        --dataset=cross_char --model=Conv4S --method=DKT \\
        [--save_iter=N] [--out=path.tar] [--num_classes=N]
    python -m deep_kernel_transfer_tpu_torch.export_checkpoint --regression \\
        --dataset=QMUL --model=Conv3 --method=DKT [--spectral] [--out=path.tar]

Port of the JAX package's root export_checkpoint.py. The flags are test's
(classification) or test_regression's (--regression), plus --out (default:
the checkpoint's name with .torch.tar) and --num_classes (the baselines'
head, default 200). The checkpoint that test or test_regression would load
(a JAX npz or a reference-layout torch file) is read through
utils/checkpoint.py::load_checkpoint and written through save_checkpoint in
the reference layout (reference train.py:57-65; DKT_regression.py:99-104,
feature_transfer_regression.py:82-83). Runs on CUDA; `main(argv,
device="cpu")` runs on the CPU.
"""
from __future__ import annotations

import os
import sys

import torch

from . import factory
from ._device import resolve_device
from .io_utils import parse_args, parse_args_regression
from .test import N_QUERY
from .train_regression import IMAGE_SIZE, init_regression_method
from .utils.checkpoint import (load_checkpoint, resolve_checkpoint_file,
                               save_checkpoint)


def _export_regression(argv: list, out, device) -> str:
    params = parse_args_regression("test_regression", argv)
    model = init_regression_method(params, device)
    ckpt_file = os.path.join(factory.regression_checkpoint_dir(params),
                             "best_model.tar")
    if not os.path.isfile(ckpt_file):
        raise SystemExit(f"no checkpoint found at {ckpt_file}")
    epoch = load_checkpoint(ckpt_file, model, IMAGE_SIZE)
    out = out or ckpt_file[:-4] + ".torch.tar"
    save_checkpoint(out, model, epoch)
    print(f"exported {ckpt_file} (epoch {epoch}) -> {out}")
    return out


def _export_classification(argv: list, out, num_classes, device) -> str:
    params = parse_args("test", argv)
    # the test surface has no --num_classes; the baselines' head needs one
    params.num_classes = num_classes if num_classes is not None else 200
    image_size = factory.resolve_image_size(params)
    factory.check_model_constraints(params)
    # way-sized parameters follow the TRAIN n_way, as in test
    model = factory.build_method(params, params.train_n_way, params.n_shot,
                                 device)
    ckpt_dir = factory.checkpoint_dir(params)
    ckpt_file = resolve_checkpoint_file(ckpt_dir, params.save_iter)
    if ckpt_file is None:
        raise SystemExit(f"no checkpoint found in {ckpt_dir}")
    if params.method in ("baseline", "baseline++"):
        shape = (2, image_size, image_size, 3)
    else:
        shape = (params.train_n_way, params.n_shot + N_QUERY, image_size,
                 image_size, 3)
    model.init(torch.zeros(shape, dtype=torch.uint8),
               torch.Generator().manual_seed(0))
    epoch = load_checkpoint(ckpt_file, model, image_size)
    out = out or (ckpt_file[:-4] if ckpt_file.endswith(".tar")
                  else ckpt_file) + ".torch.tar"
    save_checkpoint(out, model, epoch)
    print(f"exported {ckpt_file} (epoch {epoch}) -> {out}")
    return out


def main(argv=None, device=None) -> str:
    """Export; returns the path written."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device)
    out, num_classes, regression, rest = None, None, False, []
    for a in argv:  # ours; the rest is the test / test_regression surface
        if a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--num_classes="):
            num_classes = int(a.split("=", 1)[1])
        elif a == "--regression":
            regression = True
        else:
            rest.append(a)
    if regression:
        return _export_regression(rest, out, device)
    return _export_classification(rest, out, num_classes, device)


if __name__ == "__main__":
    main()
