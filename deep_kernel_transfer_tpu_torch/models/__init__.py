"""Backbones (port of deep_kernel_transfer_tpu/models): Conv4."""
from .backbones import Conv4, ConvNet

__all__ = ["Conv4", "ConvNet"]
