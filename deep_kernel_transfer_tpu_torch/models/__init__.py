"""Backbones (port of deep_kernel_transfer_tpu/models): the Conv trunks and
their NP and S forms, the ResNets, the regression trunks Conv3 and MLP2,
and the DistLinear head; and the port's own Swin Transformer trunk."""
from .backbones import (MLP2, Conv3, Conv4, Conv4NP, Conv4S, Conv4SNP, Conv6,
                        Conv6NP, ConvNet, DistLinear, ResNet, ResNet10,
                        ResNet18, ResNet34, ResNet50, ResNet101, SwinT,
                        SwinTransformer, feat_dims, model_dict,
                        np_feat_shapes)

__all__ = ["Conv3", "Conv4", "Conv4NP", "Conv4S", "Conv4SNP", "Conv6",
           "Conv6NP", "ConvNet", "DistLinear", "MLP2", "ResNet", "ResNet10",
           "ResNet18", "ResNet34", "ResNet50", "ResNet101", "SwinT",
           "SwinTransformer", "feat_dims", "model_dict", "np_feat_shapes"]
