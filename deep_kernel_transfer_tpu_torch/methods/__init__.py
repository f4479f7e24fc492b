"""Few-shot methods (port of deep_kernel_transfer_tpu/methods): DKT and
the comparison methods, with the CLI's method names, and the regression
track's DKTRegression and FeatureTransfer."""
from .baseline import BaselineTrain
from .dkt import DKT
from .dkt_regression import DKTRegression
from .feature_transfer import FeatureTransfer
from .maml import MAML
from .matchingnet import MatchingNet
from .protonet import ProtoNet
from .relationnet import RelationNet

CLASSIFICATION_METHODS = ("baseline", "baseline++", "DKT", "protonet",
                          "matchingnet", "relationnet",
                          "relationnet_softmax", "maml", "maml_approx")

__all__ = ["BaselineTrain", "DKT", "DKTRegression", "FeatureTransfer",
           "MAML", "MatchingNet", "ProtoNet", "RelationNet",
           "CLASSIFICATION_METHODS"]
