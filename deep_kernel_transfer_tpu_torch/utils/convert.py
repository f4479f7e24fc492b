"""Carry a JAX DKT's weights into the port.

The JAX package keeps a DKT's parameters as a flax/optax pytree
(`state.params`); the caller turns its leaves into numpy arrays
(`jax.tree.map(np.asarray, state.params)`) and hands the tree here. The
mapping follows the JAX package's own export to the reference's torch
layout (utils/torch_export.py:54-89, 182-192):

  * conv kernels: flax HWIO [kh, kw, I, O] -> torch OIHW;
  * BatchNorm scale/bias -> weight/bias, batch_stats {mean, var} ->
    running_mean/running_var;
  * bn_out's vectors over the flat features are permuted from the JAX
    package's HWC flatten order to the port's CHW order.

Z Z^T does not depend on the order of the features, so a wrong
permutation shows in the features and not in the loss.
"""
from __future__ import annotations

import numpy as np
import torch


def chw_to_hwc_perm(h: int, w: int, c: int) -> np.ndarray:
    """perm with v_hwc = v_chw[perm]: torch flattens [C, H, W], the JAX
    package [H, W, C]."""
    idx = np.arange(c * h * w).reshape(c, h, w)
    return idx.transpose(1, 2, 0).reshape(-1)


def _conv_oihw(kernel) -> np.ndarray:
    return np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))


def _bn(out: dict, prefix: str, params: dict, stats: dict | None,
        order=slice(None)) -> None:
    out[f"{prefix}.weight"] = np.asarray(params["scale"], np.float32)[order]
    out[f"{prefix}.bias"] = np.asarray(params["bias"], np.float32)[order]
    if stats is not None:
        out[f"{prefix}.running_mean"] = np.asarray(stats["mean"],
                                                   np.float32)[order]
        out[f"{prefix}.running_var"] = np.asarray(stats["var"],
                                                  np.float32)[order]


def _flat(tree: dict, prefix: str, out: dict) -> None:
    for key, value in tree.items():
        if isinstance(value, dict):
            _flat(value, f"{prefix}{key}.", out)
        else:
            out[f"{prefix}{key}"] = np.asarray(value, np.float32)


def dkt_state_from_jax(params: dict, model, image_size: int) -> dict:
    """The port's state_dict entries (name -> numpy array) for a JAX DKT
    params tree. A tree without "batch_stats" (a gradient tree, say) maps
    to the parameters alone."""
    feat = params["feature"]
    fp = feat["params"]
    fs = feat.get("batch_stats")
    out: dict[str, np.ndarray] = {}
    trunk = model.feature
    for i in range(trunk.depth):
        blk = fp["backbone"][f"ConvBlock_{i}"]
        out[f"feature.trunk.{i}.C.weight"] = _conv_oihw(blk["Conv_0"]["kernel"])
        out[f"feature.trunk.{i}.C.bias"] = np.asarray(blk["Conv_0"]["bias"],
                                                      np.float32)
        _bn(out, f"feature.trunk.{i}.BN", blk["EpisodicBatchNorm_0"],
            None if fs is None else
            fs["backbone"][f"ConvBlock_{i}"]["EpisodicBatchNorm_0"])
    if "EpisodicBatchNorm_0" in fp:  # bncossim's bn_out
        c, h, w = trunk.out_chw(image_size, image_size)
        to_chw = np.argsort(chw_to_hwc_perm(h, w, c))
        _bn(out, "feature.trunk.bn_out", fp["EpisodicBatchNorm_0"],
            None if fs is None else fs["EpisodicBatchNorm_0"], to_chw)
    _flat(params["gp"], "gp.", out)
    return out


def dkt_params_from_jax(params: dict, model, image_size: int):
    """Load a JAX DKT's params (numpy leaves) into the port's `model`,
    which must have been `init`-ed for the same backbone, kernel type and
    image size. Returns the model."""
    state = dkt_state_from_jax(params, model, image_size)
    device = next(model.parameters()).device
    model.load_state_dict(
        {k: torch.tensor(v, device=device) for k, v in state.items()},
        strict=True)
    return model
