"""Experiment factory: dataset, image-size, epoch and method resolution.

Port of deep_kernel_transfer_tpu/factory.py:26-220 (reference
train.py:73-182, test.py:73-115) for DKT: filelist resolution with the
cross / cross_char settings, image-size rules, default epoch schedules,
the checkpoint-directory naming that test.py and test_regression.py rely
on, every classification method (with the MAML omniglot overrides), and
the episode-parallel mesh of the CLIs.
"""
from __future__ import annotations

import os

from . import configs
from .methods import DKT, MAML, BaselineTrain, MatchingNet, ProtoNet, RelationNet
from .models import backbones
from .models.backbones import feat_dims, model_dict, np_feat_shapes


def _fallback(path: str) -> str:
    """Take ./filelists_tpu/<ds>/ (where the repo's prep scripts write)
    when the reference layout ./filelists/<ds>/ is missing."""
    if not os.path.exists(path):
        alt = path.replace("filelists/", "filelists_tpu/", 1)
        if os.path.exists(alt):
            return alt
    return path


def resolve_data_files(params, split_for_test: str | None = None):
    """(base_file, val_file) for training, or the one file of the test
    split (reference train.py:73-81, save_features.py:35-49)."""
    d = configs.data_dir
    if split_for_test is not None:
        split = split_for_test
        if params.dataset == "cross":
            if split == "base":
                return _fallback(os.path.join(d["miniImagenet"], "all.json"))
            return _fallback(os.path.join(d["CUB"], f"{split}.json"))
        if params.dataset == "cross_char":
            if split == "base":
                return _fallback(os.path.join(d["omniglot"], "noLatin.json"))
            return _fallback(os.path.join(d["emnist"], f"{split}.json"))
        return _fallback(os.path.join(d[params.dataset], f"{split}.json"))

    if params.dataset == "cross":
        base_file = os.path.join(d["miniImagenet"], "all.json")
        val_file = os.path.join(d["CUB"], "val.json")
    elif params.dataset == "cross_char":
        base_file = os.path.join(d["omniglot"], "noLatin.json")
        val_file = os.path.join(d["emnist"], "val.json")
    else:
        base_file = os.path.join(d[params.dataset], "base.json")
        val_file = os.path.join(d[params.dataset], "val.json")
    return _fallback(base_file), _fallback(val_file)


def resolve_image_size(params) -> int:
    """28 for the character datasets, 84 for Conv trunks, 224 for ResNets
    (reference train.py:83-89)."""
    if "Conv" in params.model:
        if params.dataset in ("omniglot", "cross_char"):
            return 28
        return 84
    return 224


def check_model_constraints(params) -> None:
    """omniglot and cross_char force Conv4 -> Conv4S, without augmentation
    (reference train.py:91-93)."""
    if params.dataset in ("omniglot", "cross_char"):
        if params.model not in ("Conv4", "Conv4S") or getattr(
                params, "train_aug", False):
            raise ValueError(
                "omniglot only supports Conv4 without augmentation")
        params.model = "Conv4S"


def default_stop_epoch(params) -> int:
    """reference train.py:97-113."""
    if params.method in ("baseline", "baseline++"):
        if params.dataset in ("omniglot", "cross_char"):
            return 5
        if params.dataset in ("CUB",):
            return 200
        return 400
    if params.n_shot == 1:
        return 600
    if params.n_shot == 5:
        return 400
    return 600


def mesh_size(params, model, episode_batch: int, device) -> int:
    """The number of episode-parallel ranks a run takes (JAX
    factory.py:102-126): --n_devices N forces N; by default every local GPU
    when there are several, the method has batch_loss_train and an
    optimizer, and the episode batch divides over them; else 1. A forced N
    that the method or the batch does not allow raises."""
    from .parallel.mesh import local_device_count

    n_req = getattr(params, "n_devices", None)
    # the default is every device: a torchrun group's ranks, else the
    # host's GPUs (the CPU is one device)
    n = n_req or int(os.environ.get("WORLD_SIZE", 0)) or (
        local_device_count(device) if device.type == "cuda" else 1)
    if n <= 1:
        return 1
    supported = (hasattr(model, "batch_loss_train")
                 and hasattr(model, "optimizer"))
    if not supported or episode_batch % n != 0:
        if n_req:
            raise ValueError(
                f"--n_devices={n_req} needs a method with batch_loss_train "
                f"and --episode_batch divisible by it "
                f"(episode_batch={episode_batch})")
        return 1
    return n


def resolve_mesh(params, model, episode_batch: int, device):
    """The episode-parallel Mesh of this rank (it joins the process group
    that the CLI's spawn or torchrun started), or None for the
    single-device path; `mesh_size`'s rules."""
    n = mesh_size(params, model, episode_batch, device)
    if n <= 1:
        return None
    from .parallel.mesh import make_mesh

    return make_mesh(n, device)


def use_device_data(params, data_file: str, image_size: int,
                    canvas: bool = False) -> bool:
    """The --device_data tri-state: stage the split in device memory when
    forced on, or (auto) when it fits the budget."""
    mode = getattr(params, "device_data", "off")
    if mode == "off":
        return False
    if mode == "on":
        return True
    from .data.device_dataset import fits_budget

    return fits_budget(data_file, image_size, canvas=canvas)


def train_n_query(params) -> int:
    """n_query = max(1, 16 * test_n_way / train_n_way) (train.py:132-133)."""
    return max(1, int(16 * params.test_n_way / params.train_n_way))


def kernel_type(params) -> str:
    kt = getattr(params, "kernel_type", None)
    return kt if kt else configs.kernel_type


def build_method(params, n_way: int, n_support: int, device=None):
    """The method object for classification (reference train.py:115-174;
    JAX factory.py:153-206)."""
    model_fn = model_dict[params.model]
    method = params.method
    fdtype = getattr(params, "feature_dtype", "bfloat16")
    if method in ("baseline", "baseline++"):
        # the base-class label ids must fit the head (reference
        # train.py:119-123)
        min_classes = {"omniglot": 4112, "cross_char": 1597}.get(
            params.dataset)
        if min_classes is not None and params.num_classes < min_classes:
            raise ValueError(
                f"--num_classes must be >= {min_classes} for "
                f"{params.dataset} (max base-class label id; reference "
                "train.py:119-123)")
        return BaselineTrain(
            model_fn(), params.num_classes,
            loss_type="dist" if method == "baseline++" else "softmax",
            device=device)
    if method == "DKT":
        return DKT(model_fn(), n_way, n_support,
                   kernel_type=kernel_type(params), feature_dtype=fdtype,
                   device=device)
    if method == "protonet":
        return ProtoNet(model_fn(), n_way, n_support, feature_dtype=fdtype,
                        device=device)
    if method == "matchingnet":
        return MatchingNet(model_fn(), feat_dims[params.model], n_way,
                           n_support, feature_dtype=fdtype, device=device)
    if method in ("relationnet", "relationnet_softmax"):
        backbone, shape_key = relation_backbone(params.model)
        return RelationNet(
            backbone, np_feat_shapes[shape_key], n_way, n_support,
            loss_type="mse" if method == "relationnet" else "softmax",
            feature_dtype=fdtype, device=device)
    if method in ("maml", "maml_approx"):
        kwargs = dict(approx=method == "maml_approx")
        if params.dataset in ("omniglot", "cross_char"):
            # reference train.py:169-172
            kwargs.update(n_task=32, task_update_num=1, train_lr=0.1)
        return MAML(model_fn(), n_way, n_support, device=device, **kwargs)
    raise ValueError(f"Unknown method {params.method}")


def relation_backbone(model: str):
    """(trunk, np_feat_shapes key) of RelationNet: the no-pool form of a
    Conv trunk, or an unflattened ResNet (reference train.py:145-151)."""
    np_name = {"Conv4": "Conv4NP", "Conv6": "Conv6NP",
               "Conv4S": "Conv4SNP"}.get(model)
    if np_name is not None:
        return getattr(backbones, np_name)(), np_name
    return model_dict[model](flatten=False), model


def checkpoint_dir(params) -> str:
    """save/checkpoints/<ds>/<model>_<method>[_aug][_Nway_Kshot]
    (reference train.py:178-182)."""
    path = os.path.join(configs.save_dir, "checkpoints", params.dataset,
                        f"{params.model}_{params.method}")
    if getattr(params, "train_aug", False):
        path += "_aug"
    if params.method not in ("baseline", "baseline++"):
        path += f"_{params.train_n_way}way_{params.n_shot}shot"
    return path


def regression_checkpoint_dir(params) -> str:
    """save/checkpoints/<ds>/<model>_<method>[_spectral] (reference
    train_regression.py:19-22; JAX factory.py:223-229)."""
    name = f"{params.model}_{params.method}"
    if getattr(params, "spectral", False):
        name += "_spectral"
    return os.path.join(configs.save_dir, "checkpoints", params.dataset, name)
