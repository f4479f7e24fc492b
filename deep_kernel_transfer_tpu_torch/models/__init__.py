"""Backbones (port of deep_kernel_transfer_tpu/models): the Conv trunks and
their NP and S forms, the ResNets and the DistLinear head."""
from .backbones import (Conv4, Conv4NP, Conv4S, Conv4SNP, Conv6, Conv6NP,
                        ConvNet, DistLinear, ResNet, ResNet10, ResNet18,
                        ResNet34, ResNet50, ResNet101, feat_dims, model_dict,
                        np_feat_shapes)

__all__ = ["Conv4", "Conv4NP", "Conv4S", "Conv4SNP", "Conv6", "Conv6NP",
           "ConvNet", "DistLinear", "ResNet", "ResNet10", "ResNet18",
           "ResNet34", "ResNet50", "ResNet101", "feat_dims", "model_dict",
           "np_feat_shapes"]
