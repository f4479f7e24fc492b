"""Feature-cache CLI:

    python -m deep_kernel_transfer_tpu_torch.save_features \\
        --dataset=miniImagenet --model=Conv4 --method=protonet

Port of the root save_features.py:29-114 (reference save_features.py):
the trained trunk, taken out of the method's checkpoint, embeds every
image of --split in eval mode (BatchNorm on its running averages, f32,
as the JAX package embeds), and the cache {all_feats, all_labels, count}
goes to <checkpoint dir with checkpoints -> features>/<split>[_iter].hdf5
(`.npz` beside that name when h5py is missing). The rows are written in
the JAX package's layout (flat features in HWC order, RelationNet's maps
NHWC), so that the JAX test.py reads the port's cache and the port's
test reads the JAX one. The split comes from device memory (--device_data)
or from the host loader. Runs on CUDA; `main(argv, device="cpu")` runs on
the CPU.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import factory
from ._device import resolve_device
from .data.feature_cache import save_features
from .data.filelist import SimpleDataLoader
from .io_utils import parse_args
from .models.backbones import model_dict
from .methods.base import apply_trunk
from .utils.checkpoint import load_backbone_from, resolve_checkpoint_file
from .utils.convert import features_to_jax

BATCH = 64


def feature_file_path(params) -> str:
    """<ckpt_dir with checkpoints -> features>/<split>[_<save_iter>].hdf5
    (reference save_features.py:96-101)."""
    ckpt_dir = factory.checkpoint_dir(params)
    name = (f"{params.split}_{params.save_iter}.hdf5"
            if params.save_iter != -1 else f"{params.split}.hdf5")
    return os.path.join(ckpt_dir.replace("checkpoints", "features"), name)


def method_trunk(params):
    """The trunk the method embeds with: the no-pool form for RelationNet
    (reference save_features.py:94-100), else the model's own."""
    if params.method in ("relationnet", "relationnet_softmax"):
        return factory.relation_backbone(params.model)[0]
    return model_dict[params.model]()


def main(argv=None, device=None) -> str:
    """Write the cache; returns the file written."""
    params = parse_args("save_features", argv)
    device = resolve_device(device)
    split_file = factory.resolve_data_files(params,
                                            split_for_test=params.split)
    image_size = factory.resolve_image_size(params)
    factory.check_model_constraints(params)
    if params.method in ("maml", "maml_approx"):
        raise ValueError("maml does not support save_features (reference "
                         "save_features.py:45)")
    ckpt_dir = factory.checkpoint_dir(params)
    ckpt_file = resolve_checkpoint_file(ckpt_dir, params.save_iter)
    if ckpt_file is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    trunk = method_trunk(params).to(device)
    load_backbone_from(ckpt_file, trunk)

    @torch.no_grad()
    def embed(x: torch.Tensor) -> np.ndarray:
        return apply_trunk(trunk, x.to(device), train=False)[0].cpu().numpy()

    if factory.use_device_data(params, split_file, image_size):
        from .data.device_dataset import cached_dataset

        ds = cached_dataset(split_file, image_size, device=device,
                            verbose=True)
        n = ds.images.shape[0]
        feats = np.concatenate([embed(ds.images[i:i + BATCH])
                                for i in range(0, n, BATCH)])
        labels = ds.image_labels
    else:
        loader = SimpleDataLoader(split_file, image_size, batch_size=BATCH,
                                  aug=False)
        feats, labels = [], []
        for i, (x, y) in enumerate(loader):
            feats.append(embed(torch.from_numpy(x)))
            labels.append(y)
            if i % 10 == 0:
                print(f"{i}/{len(loader)}", flush=True)
        feats, labels = np.concatenate(feats), np.concatenate(labels)
    out = feature_file_path(params)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    feats = features_to_jax(feats, trunk, image_size)
    written = save_features(out, feats, labels)
    print(f"saved {feats.shape} features to {written}", flush=True)
    return written


if __name__ == "__main__":
    main()
