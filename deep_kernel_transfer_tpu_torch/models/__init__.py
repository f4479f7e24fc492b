"""Backbones (port of deep_kernel_transfer_tpu/models): Conv4, Conv4S."""
from .backbones import Conv4, Conv4S, ConvNet, model_dict

__all__ = ["Conv4", "Conv4S", "ConvNet", "model_dict"]
