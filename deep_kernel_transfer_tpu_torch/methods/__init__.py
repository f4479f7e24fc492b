"""Few-shot methods (port of deep_kernel_transfer_tpu/methods): DKT."""
from .dkt import DKT

__all__ = ["DKT"]
