"""Carry a JAX method's weights into the port.

The JAX package keeps a method's parameters as a flax/optax pytree
(`state.params`); the caller turns its leaves into numpy arrays
(`jax.tree.map(np.asarray, state.params)`) and hands the tree here. The
mapping follows the JAX package's own export to the reference's torch
layout (utils/torch_export.py:54-137, 227-338), which is the layout of the
port's modules:

  * conv kernels: flax HWIO [kh, kw, I, O] -> torch OIHW; the bottleneck
    block's 3x3 conv keeps its bias;
  * BatchNorm scale/bias -> weight/bias, batch_stats {mean, var} ->
    running_mean/running_var;
  * flax Dense kernels [in, out] -> torch Linear weights [out, in];
    DistLinear v [in, out] / g [out] -> L.weight_v [out, in] /
    L.weight_g [out, 1];
  * flax OptimizedLSTMCell (per-gate denses `i{g}` without bias, `h{g}`
    with it) -> torch LSTM(Cell) weights stacked in gate order i, f, g, o;
    the flax bias goes into bias_ih and bias_hh is 0 (torch sums them);
  * vectors and matrix axes over the flat features of a Conv trunk (the
    bncossim bn_out, the baseline and MAML heads, MatchingNet's LSTM input
    AND hidden units, which are residual-summed with the features; on the
    regression track the spectral mixture's ARD means and scales [Q, 2916]
    and the transfer head's Linear(2916, 1) over Conv3's features) are
    permuted from the JAX package's HWC flatten order to the port's CHW
    order. Pooled trunks (the ResNets) emit channel vectors on both sides:
    no permutation. RelationNet's maps cross from NHWC to NCHW and its
    pair concat stays on the channel axis; only its fc1 input, a flattened
    post-conv map, is permuted.

Z Z^T and euclidean distances do not depend on the order of the features,
so a wrong permutation shows in the features and heads, not in a DKT or
ProtoNet loss.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.backbones import MLP2, Conv3


def chw_to_hwc_perm(h: int, w: int, c: int) -> np.ndarray:
    """perm with v_hwc = v_chw[perm]: torch flattens [C, H, W], the JAX
    package [H, W, C]."""
    idx = np.arange(c * h * w).reshape(c, h, w)
    return idx.transpose(1, 2, 0).reshape(-1)


def flatten_perm(backbone, image_size: int) -> np.ndarray:
    """perm with (JAX flat features) = (port flat features)[:, perm] for a
    flattening trunk at that image size (JAX torch_import.py:118-131); the
    identity for MLP2, whose features are no map."""
    if isinstance(backbone, MLP2):
        return np.arange(backbone.out_dim())
    c, h, w = backbone.out_chw(image_size, image_size)
    if getattr(backbone, "out_dims", None) and backbone.flatten:  # ResNet
        return np.arange(c)
    return chw_to_hwc_perm(h, w, c)


def _to_chw(perm: np.ndarray) -> np.ndarray:
    """The inverse permutation: port order from JAX order."""
    return np.argsort(perm)


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _conv_oihw(kernel) -> np.ndarray:
    return np.transpose(_f32(kernel), (3, 2, 0, 1))


def _conv(out: dict, prefix: str, conv: dict) -> None:
    out[f"{prefix}.weight"] = _conv_oihw(conv["kernel"])
    if "bias" in conv:
        out[f"{prefix}.bias"] = _f32(conv["bias"])


def _bn(out: dict, prefix: str, params: dict, stats: dict | None,
        order=slice(None)) -> None:
    out[f"{prefix}.weight"] = _f32(params["scale"])[order]
    out[f"{prefix}.bias"] = _f32(params["bias"])[order]
    if stats is not None:
        out[f"{prefix}.running_mean"] = _f32(stats["mean"])[order]
        out[f"{prefix}.running_var"] = _f32(stats["var"])[order]


def _dense(out: dict, prefix: str, dense: dict, rows=slice(None)) -> None:
    """flax Dense {kernel [in, out], bias} -> Linear weight [out, in]; the
    input axis reordered by `rows`."""
    out[f"{prefix}.weight"] = _f32(dense["kernel"])[rows].T
    out[f"{prefix}.bias"] = _f32(dense["bias"])


def flax_leaf_layout(model: torch.nn.Module, name: str):
    """(dim, stack) of the port's parameter `name` in `model`: the JAX
    leaf's trailing axis is dim `dim` of the port's tensor, over which
    `stack` JAX leaves lie end to end; None where the JAX leaf has fewer
    than 2 dimensions. From the layouts this module maps: conv kernels
    HWIO -> OIHW and Dense kernels [in, out] -> Linear [out, in] put the
    output axis at dim 0, as DistLinear's v -> weight_v does; an LSTM's
    weight_ih/weight_hh stack its four gates' [in, H] kernels, H at dim
    0; DistLinear's g [out] -> weight_g [out, 1], biases and BatchNorm
    vectors are 1-D leaves; any other parameter (a GP leaf, the spectral
    mixture's [Q, D]) keeps the JAX shape."""
    owner, _, leaf = name.rpartition(".")
    module = model.get_submodule(owner)
    if isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
        return (0, 1) if leaf == "weight" else None
    if isinstance(module, (torch.nn.LSTM, torch.nn.LSTMCell)):
        return (0, 4) if leaf.startswith("weight_") else None
    if leaf == "weight_v":
        return (0, 1)
    if leaf == "weight_g":
        return None
    ndim = getattr(module, leaf).dim()
    return (ndim - 1, 1) if ndim >= 2 else None


def _sub(stats: dict | None, key: str):
    return None if stats is None else stats[key]


def backbone_state_from_jax(fvars: dict, backbone, prefix: str) -> dict:
    """The port's state entries (name -> numpy) of one trunk from its flax
    variables {"params", "batch_stats" (optional)}: the Conv trunks
    (ConvBlock_{i}) or the ResNets (stem Conv_0/EpisodicBatchNorm_0, then
    SimpleBlock_{b} / BottleneckBlock_{b} at trunk.{4+b}) (JAX
    torch_export.py:73-137)."""
    params, stats = fvars["params"], fvars.get("batch_stats")
    out: dict[str, np.ndarray] = {}
    if isinstance(backbone, Conv3):  # JAX torch_export.py:127-134
        for i in range(3):
            _conv(out, f"{prefix}layer{i + 1}", params[f"Conv_{i}"])
        return out
    if isinstance(backbone, MLP2):
        for i in range(2):
            _dense(out, f"{prefix}layer{i + 1}", params[f"Dense_{i}"])
        return out
    if not hasattr(backbone, "out_dims"):  # a Conv trunk
        for i in range(backbone.depth):
            blk = params[f"ConvBlock_{i}"]
            _conv(out, f"{prefix}trunk.{i}.C", blk["Conv_0"])
            _bn(out, f"{prefix}trunk.{i}.BN", blk["EpisodicBatchNorm_0"],
                None if stats is None else
                stats[f"ConvBlock_{i}"]["EpisodicBatchNorm_0"])
        return out
    _conv(out, f"{prefix}trunk.0", params["Conv_0"])
    _bn(out, f"{prefix}trunk.1", params["EpisodicBatchNorm_0"],
        _sub(stats, "EpisodicBatchNorm_0"))
    blocks = backbone.trunk[4:4 + sum(backbone.num_layers)]
    for b, block in enumerate(blocks):
        name = f"{type(block).__name__}_{b}"
        p, s = params[name], _sub(stats, name)
        n_convs = 3 if hasattr(block, "C3") else 2
        for ci in range(n_convs):
            t = f"{prefix}trunk.{4 + b}"
            _conv(out, f"{t}.C{ci + 1}", p[f"Conv_{ci}"])
            _bn(out, f"{t}.BN{ci + 1}", p[f"EpisodicBatchNorm_{ci}"],
                None if s is None else s[f"EpisodicBatchNorm_{ci}"])
        if block.shortcut is not None:
            _conv(out, f"{prefix}trunk.{4 + b}.shortcut", p[f"Conv_{n_convs}"])
            if n_convs == 2:  # the basic block's shortcut has a BatchNorm
                _bn(out, f"{prefix}trunk.{4 + b}.BNshortcut",
                    p[f"EpisodicBatchNorm_{n_convs}"],
                    None if s is None else s[f"EpisodicBatchNorm_{n_convs}"])
    return out


def _flat(tree: dict, prefix: str, out: dict) -> None:
    for key, value in tree.items():
        if isinstance(value, dict):
            _flat(value, f"{prefix}{key}.", out)
        else:
            out[f"{prefix}{key}"] = _f32(value)


def _split_vars(tree: dict, key: str) -> dict:
    """{"params": tree["params"][key], "batch_stats": ...[key]} of a
    submodule of a flax variables dict."""
    out = {"params": tree["params"][key]}
    if "batch_stats" in tree:
        out["batch_stats"] = tree["batch_stats"][key]
    return out


def lstm_state_from_jax(cell: dict, prefix: str, perm_in: np.ndarray,
                        perm_h: np.ndarray, suffix: str = "") -> dict:
    """One flax OptimizedLSTMCell -> torch weight_ih/weight_hh/bias_ih/
    bias_hh{suffix} (JAX torch_export.py:266-285): gates stacked i, f, g,
    o; the input and hidden units reordered from JAX to port order."""
    inv_in, inv_h = _to_chw(perm_in), _to_chw(perm_h)
    w_ih, w_hh, b = [], [], []
    for g in ("i", "f", "g", "o"):
        w_ih.append(_f32(cell[f"i{g}"]["kernel"])[inv_in][:, inv_h].T)
        w_hh.append(_f32(cell[f"h{g}"]["kernel"])[inv_h][:, inv_h].T)
        b.append(_f32(cell[f"h{g}"]["bias"])[inv_h])
    b = np.concatenate(b)
    return {f"{prefix}weight_ih{suffix}": np.concatenate(w_ih),
            f"{prefix}weight_hh{suffix}": np.concatenate(w_hh),
            f"{prefix}bias_ih{suffix}": b,
            f"{prefix}bias_hh{suffix}": np.zeros_like(b)}


def _dkt(params: dict, model, image_size: int) -> dict:
    feat = params["feature"]
    fp, fs = feat["params"], feat.get("batch_stats")
    trunk = model.feature
    out = backbone_state_from_jax(
        {"params": fp["backbone"], **({} if fs is None else
                                      {"batch_stats": fs["backbone"]})},
        trunk, "feature.")
    if "EpisodicBatchNorm_0" in fp:  # bncossim's bn_out
        _bn(out, "feature.trunk.bn_out", fp["EpisodicBatchNorm_0"],
            _sub(fs, "EpisodicBatchNorm_0"),
            _to_chw(flatten_perm(trunk, image_size)))
    _flat(params["gp"], "gp.", out)
    return out


def _protonet(params: dict, model, image_size: int) -> dict:
    return backbone_state_from_jax(params["feature"], model.feature,
                                   "feature.")


def _matchingnet(params: dict, model, image_size: int) -> dict:
    out = backbone_state_from_jax(params["feature"], model.feature,
                                  "feature.")
    perm = flatten_perm(model.feature, image_size)
    d = perm.shape[0]
    g = params["G"]["params"]
    out.update(lstm_state_from_jax(
        params["FCE"]["params"]["OptimizedLSTMCell_0"], "FCE.lstmcell.",
        np.concatenate([perm, perm + d]), perm))
    out.update(lstm_state_from_jax(g["OptimizedLSTMCell_0"], "G_encoder.",
                                   perm, perm, "_l0"))
    out.update(lstm_state_from_jax(g["OptimizedLSTMCell_1"], "G_encoder.",
                                   perm, perm, "_l0_reverse"))
    return out


def _relationnet(params: dict, model, image_size: int) -> dict:
    from ..methods.relationnet import relation_module_geometry

    out = backbone_state_from_jax(params["feature"], model.feature,
                                  "feature.")
    rel = params["relation"]
    rp, rs = rel["params"], rel.get("batch_stats")
    for i, layer in enumerate(("layer1", "layer2")):
        blk = rp[f"RelationConvBlock_{i}"]
        _conv(out, f"relation_module.{layer}.C", blk["Conv_0"])
        _bn(out, f"relation_module.{layer}.BN", blk["EpisodicBatchNorm_0"],
            None if rs is None else
            rs[f"RelationConvBlock_{i}"]["EpisodicBatchNorm_0"])
    c, h, w = model.feat_shape
    hs, ws, _ = relation_module_geometry(h, w)
    rows = (_to_chw(chw_to_hwc_perm(hs, ws, c)) if hs * ws > 1
            else slice(None))
    _dense(out, "relation_module.fc1", rp["Dense_0"], rows)
    _dense(out, "relation_module.fc2", rp["Dense_1"])
    return out


def _net_with_head(params: dict, model, image_size: int) -> dict:
    """MAML's MAMLNet and the baseline's BaselineClassifier: the trunk
    under net/backbone, and a Dense_0 or DistLinear_0 head over its flat
    features."""
    net = params["net"]
    out = backbone_state_from_jax(_split_vars(net, "backbone"),
                                  model.feature, "feature.")
    rows = _to_chw(flatten_perm(model.feature, image_size))
    head = net["params"]
    if "Dense_0" in head:
        _dense(out, "classifier", head["Dense_0"], rows)
    else:
        out["classifier.L.weight_v"] = _f32(head["DistLinear_0"]["v"])[rows].T
        out["classifier.L.weight_g"] = _f32(
            head["DistLinear_0"]["g"]).reshape(-1, 1)
    return out


def dkt_regression_state_from_jax(params: dict, model,
                                  image_size: int = 100) -> dict:
    """DKTRegression: the trunk under feature, the GP's leaves under gp.;
    the spectral mixture's raw_means and raw_scales [Q, D] from HWC to CHW
    order over a Conv3's features (JAX torch_export.py:339-369). Both
    packages keep the noise as softplus(raw_noise)."""
    out = backbone_state_from_jax(params["feature"], model.feature,
                                  "feature.")
    gp = {k: dict(v) for k, v in params["gp"].items()}
    if "raw_means" in gp["kernel"]:
        rows = _to_chw(flatten_perm(model.feature, image_size))
        for key in ("raw_means", "raw_scales"):
            gp["kernel"][key] = _f32(gp["kernel"][key])[:, rows]
    _flat(gp, "gp.", out)
    return out


def feature_transfer_state_from_jax(params: dict, model,
                                    image_size: int = 100) -> dict:
    """FeatureTransfer: TransferNet's backbone under feature_extractor.,
    its Dense_0 as model.layer4 with the input axis from HWC to CHW order
    (JAX torch_export.py:372-385)."""
    net = params["net"]["params"]
    out = backbone_state_from_jax({"params": net["backbone"]},
                                  model.feature_extractor,
                                  "feature_extractor.")
    _dense(out, "model.layer4", net["Dense_0"],
           _to_chw(flatten_perm(model.feature_extractor, image_size)))
    return out


def sines_maml_state_from_jax(params: dict, model, image_size=None) -> dict:
    """SinesMAML's MLP 1->40->40->1: flax Dense_{0,1,2} as layer{1,2,3}."""
    out: dict[str, np.ndarray] = {}
    for i in range(3):
        _dense(out, f"net.layer{i + 1}", params["params"][f"Dense_{i}"])
    return out


_CONVERTERS = {"DKT": _dkt, "ProtoNet": _protonet,
               "MatchingNet": _matchingnet, "RelationNet": _relationnet,
               "MAML": _net_with_head, "BaselineTrain": _net_with_head,
               "DKTRegression": dkt_regression_state_from_jax,
               "FeatureTransfer": feature_transfer_state_from_jax,
               "SinesMAML": sines_maml_state_from_jax}


def state_from_jax(params: dict, model, image_size: int) -> dict:
    """The port's state_dict entries (name -> numpy array) of a JAX
    method's params tree, for the port's method object of the same kind
    (DKT, ProtoNet, MatchingNet, RelationNet, MAML, BaselineTrain,
    DKTRegression, FeatureTransfer, SinesMAML). A tree
    without "batch_stats" (a gradient tree, say) maps to the parameters
    alone."""
    return _CONVERTERS[type(model).__name__](params, model, image_size)


def dkt_state_from_jax(params: dict, model, image_size: int) -> dict:
    return _dkt(params, model, image_size)


def params_from_jax(params: dict, model, image_size: int):
    """Load a JAX method's params (numpy leaves) into the port's `model`,
    which must have been `init`-ed for the same backbone, heads and image
    size. Returns the model."""
    state = state_from_jax(params, model, image_size)
    device = next(model.parameters()).device
    model.load_state_dict(
        {k: torch.tensor(v, device=device) for k, v in state.items()},
        strict=True)
    return model


dkt_params_from_jax = params_from_jax


def features_to_jax(feats: np.ndarray, backbone, image_size: int
                    ) -> np.ndarray:
    """A feature cache's rows in the JAX package's layout, from the port's:
    flat features [N, D] from CHW to HWC order, maps [N, C, H, W] to
    [N, H, W, C], so that either package reads a cache the other wrote."""
    if feats.ndim == 4:
        return np.ascontiguousarray(feats.transpose(0, 2, 3, 1))
    return feats[:, flatten_perm(backbone, image_size)]


def features_from_jax(feats: np.ndarray, backbone, image_size: int
                      ) -> np.ndarray:
    """The inverse of features_to_jax over the last axes of feature
    episodes [..., D] or [..., H, W, C]."""
    if backbone is None:  # maps
        return np.ascontiguousarray(np.moveaxis(feats, -1, -3))
    return feats[..., _to_chw(flatten_perm(backbone, image_size))]
