"""Checkpoints in the reference's torch layout, with its naming and discovery.

Port of deep_kernel_transfer_tpu/utils/checkpoint.py. Files are
<ckpt_dir>/{best_model.tar, <epoch>.tar} (reference train.py:57-65) and
are found as the reference finds them (io_utils.py:66-86; JAX
checkpoint.py:96-136).

A file is `torch.save({'epoch': e, 'state': sd})` with `sd` in the
reference's state_dict layout of the method (JAX utils/torch_export.py
:227-338): the port's modules carry the reference's names (feature.*,
classifier.*, G_encoder.*, FCE.lstmcell.*, relation_module.*), and a DKT's
per-way GP is written as gpytorch names it (reference methods/DKT.py
:337-378), model.models.{w}.mean_module.constant,
model.models.{w}.covar_module.raw_outputscale and
model.models.{w}.covar_module.base_kernel.raw_{variance|lengthscale|offset}.
Beside them are the entries a reference state_dict also holds and the JAX
exporter writes: each BatchNorm's num_batches_tracked, a ConvBlock's
layers again under their Sequential names, the GP mean's raw_constant and
the likelihoods' raw noise. That is the layout the JAX package imports
(utils/torch_import.py), so its test.py evaluates a checkpoint of the
port's train, and the layout `export_checkpoint` writes.

The regression methods keep the reference's own layouts, each part a
state_dict (JAX utils/torch_export.py:339-385): DKTRegression as
{'gp', 'likelihood', 'net'} (reference methods/DKT_regression.py:99-104),
with gpytorch's names for the GP (mean_module.raw_constant,
covar_module.raw_outputscale, covar_module.base_kernel.raw_lengthscale,
or covar_module.raw_mixture_{weights,means,scales} with means and scales
[Q, 1, D] over CHW-ordered features) and the noise under gpytorch's
GreaterThan(1e-4), noise = softplus(raw) + 1e-4; FeatureTransfer as
{'feature_extractor', 'model'} (reference
feature_transfer_regression.py:82-83). The port adds an 'epoch' entry,
which the reference's and the JAX package's loaders ignore.

`load_checkpoint` reads that layout, and also the JAX package's own npz
checkpoints (leaves keyed by their keystr path, JAX checkpoint.py:28-41),
parsed without JAX and loaded through utils/convert.params_from_jax.
`warmup_from_baseline` and `load_backbone_from` graft a checkpoint's trunk
into another model (JAX checkpoint.py:139-222).
"""
from __future__ import annotations

import glob
import os
import re
import sys
import zipfile
from typing import Optional

import numpy as np
import torch

from .convert import backbone_state_from_jax, params_from_jax

# gpytorch's name and shape of each base-kernel parameter
_BASE_SHAPES = {"raw_variance": (1,), "raw_lengthscale": (1, 1),
                "raw_offset": ()}


def _gp_key(w: int, leaf: str) -> str:
    p = f"model.models.{w}."
    if leaf == "mean.constant":
        return p + "mean_module.constant"
    if leaf == "kernel.raw_outputscale":
        return p + "covar_module.raw_outputscale"
    return p + "covar_module.base_kernel." + leaf.removeprefix("kernel.base.")


# a ConvBlock's layers under their Sequential aliases: .C. -> .trunk.0.,
# .BN. -> .trunk.1. (not ResNet's C1/BN1 or bn_out)
_ALIAS = re.compile(r"\.(C|BN)\.(?=[a-z_]+$)")
_ALIAS_INDEX = {"C": "0", "BN": "1"}


def _reference_state(model, state: Optional[dict] = None
                     ) -> dict[str, torch.Tensor]:
    """The reference layout of a method's state_dict, on the CPU, as the
    JAX exporter writes it (utils/torch_export.py:61-226): the module's
    entries; each BatchNorm's num_batches_tracked (0); a ConvBlock's C and
    BN again under their Sequential aliases trunk.0 and trunk.1 (the
    reference registers those layers twice); a DKT's per-way GP in
    gpytorch's names, with the mean's raw_constant beside its constant and
    the likelihoods' raw noise under GreaterThan(1e-4). `state` stands
    for model.state_dict() where given."""
    out = {}
    for name, value in (model.state_dict() if state is None
                        else state).items():
        value = value.detach().cpu()
        if not name.startswith("gp."):
            out[name] = value.clone()
            continue
        leaf = name.removeprefix("gp.")
        shape = (1,) if leaf == "mean.constant" else _BASE_SHAPES.get(
            leaf.removeprefix("kernel.base."), ())
        for w in range(value.shape[0]):
            out[_gp_key(w, leaf)] = value[w].reshape(shape).clone()
            if leaf == "mean.constant":
                out[f"model.models.{w}.mean_module.raw_constant"] = (
                    value[w].reshape(()).clone())
    for name in [n for n in out if n.endswith(".running_var")]:
        out[name.removesuffix("running_var") + "num_batches_tracked"] = (
            torch.zeros((), dtype=torch.int64))
    for name in list(out):
        alias = _ALIAS.sub(lambda m: f".trunk.{_ALIAS_INDEX[m.group(1)]}.",
                           name)
        if alias != name:
            out[alias] = out[name].clone()
    if type(model).__name__ == "DKT":
        raw = torch.tensor(np.asarray(_noise_raw(
            model.spec.likelihood.fixed_noise), np.float32).reshape(1))
        for w in range(model.gp.tree()["mean"]["constant"].shape[0]):
            out[f"model.models.{w}.likelihood.noise_covar.raw_noise"] = (
                raw.clone())
            out[f"likelihood.likelihoods.{w}.noise_covar.raw_noise"] = (
                raw.clone())
    return out


# DKTRegression's GP leaves -> gpytorch's names (JAX torch_import.py:614-657)
_REGRESSION_GP = {"mean.constant": "mean_module.raw_constant",
                  "kernel.raw_outputscale": "covar_module.raw_outputscale",
                  "kernel.base.raw_lengthscale":
                      "covar_module.base_kernel.raw_lengthscale",
                  "kernel.raw_weights": "covar_module.raw_mixture_weights",
                  "kernel.raw_means": "covar_module.raw_mixture_means",
                  "kernel.raw_scales": "covar_module.raw_mixture_scales"}
_NOISE_FLOOR = 1e-4  # gpytorch GaussianLikelihood's GreaterThan(1e-4)
_REGRESSION_METHODS = ("DKTRegression", "FeatureTransfer")


def _softplus(x):
    return np.logaddexp(0.0, np.asarray(x, np.float64))


def _inv_softplus(y):
    y = np.asarray(y, np.float64)
    return y + np.log1p(-np.exp(-y))


def _noise_raw(noise):
    """gpytorch's raw noise of a noise value: softplus(raw) + 1e-4."""
    return _inv_softplus(np.maximum(np.asarray(noise, np.float64)
                                    - _NOISE_FLOOR, 1e-8))


def _reference_gp_shape(leaf: str, value: torch.Tensor) -> tuple:
    if leaf == "kernel.base.raw_lengthscale":
        return (1, 1)
    if leaf in ("kernel.raw_means", "kernel.raw_scales"):
        return (value.shape[0], 1, value.shape[1])
    return tuple(value.shape)


def _regression_blob(model) -> dict:
    """The reference's multi-part layout of a regression method."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    if type(model).__name__ == "FeatureTransfer":
        parts = {"feature_extractor": {}, "model": {}}
        for name, value in sd.items():
            part, key = name.split(".", 1)
            parts[part][key] = value
        return parts
    net = {k.removeprefix("feature."): v for k, v in sd.items()
           if k.startswith("feature.")}
    gp = {}
    for leaf, key in _REGRESSION_GP.items():
        value = sd.get(f"gp.{leaf}")
        if value is not None:
            gp[key] = value.reshape(_reference_gp_shape(leaf, value))
    gp["mean_module.constant"] = sd["gp.mean.constant"].reshape(1)
    raw = _noise_raw(_softplus(sd["gp.likelihood.raw_noise"].numpy()))
    likelihood = {"noise_covar.raw_noise": torch.tensor(
        np.asarray(raw, np.float32).reshape(1))}
    return {"gp": gp, "likelihood": likelihood, "net": net}


def _load_regression(blob: dict, model) -> None:
    """A regression method's state_dict from the reference's layout (also
    as the reference wrote it: mean_module.constant, or the noise inside
    the 'gp' part)."""
    own = model.state_dict()
    if "feature_extractor" in blob:
        sd = {f"{part}.{k}": v for part in ("feature_extractor", "model")
              for k, v in blob[part].items()}
    else:
        gp = blob["gp"]
        sd = {f"feature.{k}": v for k, v in blob["net"].items()}
        for leaf, key in _REGRESSION_GP.items():
            name = f"gp.{leaf}"
            if name not in own:
                continue
            value = gp.get(key)
            if value is None and leaf == "mean.constant":
                value = gp["mean_module.constant"]
            sd[name] = value.reshape(own[name].shape)
        raw = blob.get("likelihood", {}).get("noise_covar.raw_noise")
        if raw is None:
            raw = gp["likelihood.noise_covar.raw_noise"]
        noise = _softplus(raw.numpy()) + _NOISE_FLOOR
        sd["gp.likelihood.raw_noise"] = torch.tensor(
            np.asarray(_inv_softplus(noise), np.float32).reshape(()))
    model.load_state_dict({k: v.to(model.device) for k, v in sd.items()},
                          strict=True)


def save_checkpoint(path: str, model, epoch: int = -1,
                    state: Optional[dict] = None) -> None:
    """torch.save of `model` in the reference layout: {'epoch', 'state'},
    or a regression method's multi-part layout with its 'epoch'. `state`
    stands for model.state_dict() where given (the full state of a
    tensor-parallel model, parallel.gather_state)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if type(model).__name__ in _REGRESSION_METHODS:
        blob = {"epoch": int(epoch), **_regression_blob(model)}
    else:
        blob = {"epoch": int(epoch), "state": _reference_state(model, state)}
    torch.save(blob, path)


def _is_torch_checkpoint(path: str) -> bool:
    """A torch.save archive holds data.pkl; the JAX package's npz holds
    __epoch__.npy."""
    with zipfile.ZipFile(path) as zf:
        return any(n.endswith("data.pkl") for n in zf.namelist())


def _load_reference(path: str, model) -> int:
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if type(model).__name__ in _REGRESSION_METHODS:
        _load_regression(blob, model)
        return int(blob.get("epoch", -1))
    state = blob["state"]
    sd = {}
    for name, value in model.state_dict().items():
        if not name.startswith("gp."):
            sd[name] = state[name]
            continue
        leaf = name.removeprefix("gp.")
        ways = []
        for w in range(value.shape[0]):
            key = _gp_key(w, leaf)
            if leaf == "mean.constant" and key not in state:
                key = key.replace(".constant", ".raw_constant")
            ways.append(state[key].reshape(()))
        sd[name] = torch.stack(ways)
    model.load_state_dict({k: v.to(model.device) for k, v in sd.items()},
                          strict=True)
    return int(blob.get("epoch", -1))


def _read_npz(path: str) -> tuple[dict, int]:
    with np.load(path, allow_pickle=False) as z:
        return _npz_tree(z), int(z["__epoch__"])


_KEYSTR = re.compile(r"\['([^']*)'\]")


def _npz_tree(z) -> dict:
    """The nested dict of a JAX npz checkpoint: each leaf's keystr path
    ['a']['b']... back into dict keys."""
    tree: dict = {}
    for key in z.files:
        if key == "__epoch__":
            continue
        parts = _KEYSTR.findall(key)
        if "".join(f"['{p}']" for p in parts) != key:
            raise ValueError(f"unexpected leaf path {key!r}")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    return tree


def load_checkpoint(path: str, model, image_size: int) -> int:
    """Load a reference-layout torch checkpoint, or a JAX npz checkpoint of
    the same method, into `model` (init-ed for the same backbone, heads and
    image size). Returns the checkpoint's epoch."""
    if _is_torch_checkpoint(path):
        return _load_reference(path, model)
    tree, epoch = _read_npz(path)
    params_from_jax(tree, model, image_size)
    return epoch


def _jax_trunk_vars(tree: dict) -> dict:
    """The trunk's flax variables in a JAX method's params tree: under
    net/backbone (baseline, MAML), feature/backbone (DKT) or feature."""
    def split(node: dict, key: str) -> dict:
        out = {"params": node["params"][key]}
        if key in node.get("batch_stats", {}):
            out["batch_stats"] = node["batch_stats"][key]
        return out

    if "net" in tree:
        return split(tree["net"], "backbone")
    feat = tree["feature"]
    return split(feat, "backbone") if "backbone" in feat["params"] else feat


def load_backbone_from(path: str, trunk) -> int:
    """Graft the trunk of the checkpoint at `path` (reference layout, its
    `feature.` keys; or a JAX npz) into `trunk`: every entry of the trunk's
    state_dict that the checkpoint holds with the same shape. Raises when
    there is none. Returns the number of entries loaded."""
    if _is_torch_checkpoint(path):
        state = torch.load(path, map_location="cpu", weights_only=True)
        src = {k.removeprefix("feature."): v for k, v in
               state["state"].items() if k.startswith("feature.")}
    else:
        src = {k: torch.from_numpy(v) for k, v in backbone_state_from_jax(
            _jax_trunk_vars(_read_npz(path)[0]), trunk, "").items()}
    own = trunk.state_dict()
    hits = {k: v for k, v in src.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    if not hits:
        raise ValueError(f"no trunk entries of {path} fit the model")
    device = next(trunk.parameters()).device
    trunk.load_state_dict({k: v.to(device) for k, v in hits.items()},
                          strict=False)
    print(f"loaded {len(hits)} trunk entries from {path}")
    return len(hits)


def warmup_from_baseline(warm_dir: str, model) -> int:
    """The --warmup of train: the trunk of the baseline's best (or latest)
    checkpoint in warm_dir into model.feature (reference train.py:198-217;
    JAX checkpoint.py:139-155)."""
    src = get_best_file(warm_dir)
    if src is None:
        raise ValueError(f"no warmup checkpoint found in {warm_dir}")
    return load_backbone_from(src, model.feature)


# -- discovery (reference io_utils.py:66-86) --------------------------------


def get_assigned_file(checkpoint_dir: str, num: int) -> str:
    return os.path.join(checkpoint_dir, f"{num}.tar")


def get_resume_file(checkpoint_dir: str) -> Optional[str]:
    filelist = glob.glob(os.path.join(checkpoint_dir, "*.tar"))
    filelist = [x for x in filelist if os.path.basename(x) != "best_model.tar"]
    if not filelist:
        return None
    epochs = [int(os.path.splitext(os.path.basename(x))[0]) for x in filelist]
    return os.path.join(checkpoint_dir, f"{max(epochs)}.tar")


def get_best_file(checkpoint_dir: str) -> Optional[str]:
    best = os.path.join(checkpoint_dir, "best_model.tar")
    if os.path.isfile(best):
        return best
    return get_resume_file(checkpoint_dir)


def resolve_checkpoint_file(checkpoint_dir: str,
                            save_iter: int = -1) -> Optional[str]:
    """test.py's checkpoint (reference test.py:95-100): the --save_iter
    epoch's file, else best_model.tar or the latest epoch. Warns on stderr
    when there is none: the run then evaluates freshly initialised
    weights, as the reference does."""
    if save_iter != -1:
        f = get_assigned_file(checkpoint_dir, save_iter)
    else:
        f = get_best_file(checkpoint_dir)
    if f is None:
        print(f"[WARNING] no checkpoint found in {checkpoint_dir} — "
              "evaluating RANDOMLY-INITIALISED weights", file=sys.stderr)
    return f
