"""PyTorch/CUDA port of deep_kernel_transfer_tpu.

The JAX package `deep_kernel_transfer_tpu` stays the reference; this package
mirrors its layout (`gp/`, `models/`, `methods/`, `ops/`, `data/`, `utils/`,
`sines/`, the `train`, `save_features`, `test`, `test_uncertainty`,
`train_regression` and `test_regression` CLIs) and imports none of it.
Entry points run on CUDA unless the caller passes `device="cpu"`; the
hand-written kernels live in `csrc/` and are built with nvcc at first
use.
"""
