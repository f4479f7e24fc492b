"""The benchmark of deep_kernel_transfer_tpu_torch (see README.md)."""
