"""Few-shot methods (port of deep_kernel_transfer_tpu/methods): DKT and
the comparison methods, with the CLI's method names."""
from .baseline import BaselineTrain
from .dkt import DKT
from .maml import MAML
from .matchingnet import MatchingNet
from .protonet import ProtoNet
from .relationnet import RelationNet

CLASSIFICATION_METHODS = ("baseline", "baseline++", "DKT", "protonet",
                          "matchingnet", "relationnet",
                          "relationnet_softmax", "maml", "maml_approx")

__all__ = ["BaselineTrain", "DKT", "MAML", "MatchingNet", "ProtoNet",
           "RelationNet", "CLASSIFICATION_METHODS"]
