"""The port's backbone zoo (deep_kernel_transfer_tpu_torch/models) against the
JAX package's trunks, on the same numpy inputs and weights carried across
with utils.convert.backbone_state_from_jax:

  * Conv6, Conv4NP, Conv6NP and Conv4SNP at 16-32 px, ResNet10 and
    ResNet18 at 64 px (at 32 px the last stage's map is 1x1, and train-mode
    BatchNorm over an episode's 4 values a channel scales the f32
    rounding of either package past 1e-5 of a float64 forward), and a
    narrow ResNet of BottleneckBlocks (the
    bottleneck stage with its conv bias and its shortcut without
    BatchNorm), in eval mode and in train mode with ep_groups 1 and 2,
    with the running averages after a train step;
  * ResNet34/50/101: the state_dict's names and shapes against the JAX
    package's torch export and the parameter count, without running them;
  * DistLinear against the JAX DistLinear.

BatchNorm scales, shifts and running statistics are randomised so that
eval mode is not the identity. Flat features are compared after the
port's CHW order is permuted to the JAX package's HWC order, maps after
NCHW -> NHWC. Forward tolerance 1e-5 of the largest feature or 1e-5
absolute, the larger (the deep trunks' features reach 5-20, and train
mode's per-episode statistics scale up the convolutions' rounding, as
tests/test_torch_backbones.py holds it).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu.methods import base as jbase
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu.utils import torch_export
from deep_kernel_transfer_tpu_torch.methods import base as tbase
from deep_kernel_transfer_tpu_torch.models import backbones as tbb
from deep_kernel_transfer_tpu_torch.utils.convert import (
    backbone_state_from_jax, flatten_perm)
from torch_test_threads import one_thread  # noqa: F401

N_IMG = 8


def _randomise_bn(tree, rng):
    """Random BatchNorm scale/bias/mean/var in a flax variables tree."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "mean" or (k == "bias" and "scale" in tree):
            out[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
        else:
            out[k] = _randomise_bn(v, rng)
    return out


# name -> (JAX trunk, port trunk, image size)
CASES = {
    "Conv6": (lambda: jbb.Conv6(), tbb.Conv6, 32),
    "Conv4NP": (lambda: jbb.Conv4NP(), tbb.Conv4NP, 24),
    "Conv6NP": (lambda: jbb.Conv6NP(), tbb.Conv6NP, 24),
    "Conv4SNP": (lambda: jbb.Conv4SNP(), tbb.Conv4SNP, 16),
    "ResNet10": (lambda: jbb.ResNet10(), tbb.ResNet10, 64),
    "ResNet18": (lambda: jbb.ResNet18(), tbb.ResNet18, 64),
    "Bottleneck": (lambda: jbb.ResNet(jbb.BottleneckBlock, [1, 1, 1, 1],
                                      [16, 32, 64, 128]),
                   lambda: tbb.ResNet(tbb.BottleneckBlock, [1, 1, 1, 1],
                                      [16, 32, 64, 128]), 64),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    jfn, tfn, px = CASES[request.param]
    x = np.random.RandomState(0).randint(0, 256, (N_IMG, px, px, 3)).astype(
        np.uint8)
    jm = jfn()
    fvars = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x[:2])))
    fvars = _randomise_bn(fvars, np.random.RandomState(1))
    tm = tfn()
    state = backbone_state_from_jax(fvars, tm, "")
    tm.load_state_dict({k: torch.tensor(v) for k, v in state.items()},
                       strict=True)
    return dict(name=request.param, jm=jm, fvars=fvars, tm=tm, x=x, px=px)


def _to_jax_layout(pair, out):
    if out.ndim == 4:
        return out.transpose(0, 2, 3, 1)
    return out[:, flatten_perm(pair["tm"], pair["px"])]


def _run(pair, train, ep_groups=1):
    want, jstats = jbase.apply_trunk(
        pair["jm"], jax.tree.map(jnp.asarray, pair["fvars"]),
        jnp.asarray(pair["x"]), train, dtype=jnp.float32, ep_groups=ep_groups)
    with torch.no_grad():
        got, stats = tbase.apply_trunk(pair["tm"], torch.from_numpy(pair["x"]),
                                       train, dtype=torch.float32,
                                       ep_groups=ep_groups)
    return np.asarray(want), jstats, _to_jax_layout(pair, got.numpy()), stats


def test_eval_forward_matches_jax(pair):
    want, _, got, stats = _run(pair, train=False)
    assert stats is None and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("ep_groups", [1, 2])
def test_train_forward_and_running_stats_match_jax(pair, ep_groups):
    want, jstats, got, stats = _run(pair, train=True, ep_groups=ep_groups)
    assert np.abs(got - want).max() < 1e-5 * max(1.0, np.abs(want).max())
    merged = jbase.merge_stats(jax.tree.map(jnp.asarray, pair["fvars"]),
                               jstats)
    want_state = backbone_state_from_jax(jax.tree.map(np.asarray, merged),
                                         pair["tm"], "")
    got_state = {}
    for bn, (mean, var) in stats.items():
        name = next(n for n, m in pair["tm"].named_modules() if m is bn)
        got_state[f"{name}.running_mean"] = mean.numpy()
        got_state[f"{name}.running_var"] = var.numpy()
    assert set(got_state) == {k for k in want_state if "running" in k}
    for k, v in got_state.items():
        assert np.abs(v - want_state[k]).max() < 1e-5 * max(
            1.0, np.abs(want_state[k]).max()), k


@pytest.mark.parametrize("name", ["ResNet34", "ResNet50", "ResNet101"])
def test_deep_resnet_names_and_counts(name):
    """The port's state_dict is the JAX export's reference layout (names,
    shapes; the export's Sequential aliases and num_batches_tracked
    aside), and the parameter counts agree."""
    jm = getattr(jbb, name)()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    fvars = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    exported = torch_export.export_backbone(fvars, jm, prefix="")
    exported = {k: v.shape for k, v in exported.items()
                if not k.endswith("num_batches_tracked")}
    tm = getattr(tbb, name)()
    own = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert own == {k: tuple(v) for k, v in exported.items()}
    assert set(backbone_state_from_jax(fvars, tm, "")) == set(own)
    n_jax = sum(int(np.prod(s.shape)) for s in
                jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax


def test_distlinear_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 20).astype(np.float32)
    for out_dim, scale in ((5, 2.0), (201, 10.0)):
        jm = jbb.DistLinear(out_dim)
        p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), x))
        p["params"]["g"] = rng.uniform(0.5, 2.0, out_dim).astype(np.float32)
        tm = tbb.DistLinear(20, out_dim)
        assert tm.scale_factor == scale
        with torch.no_grad():
            tm.L.weight_v.copy_(torch.from_numpy(p["params"]["v"].T))
            tm.L.weight_g.copy_(torch.from_numpy(p["params"]["g"])[:, None])
            got = tm(torch.from_numpy(x)).numpy()
        want = np.asarray(jm.apply(p, jnp.asarray(x)))
        assert np.abs(got - want).max() < 1e-5


def test_model_dict_and_shapes():
    # SwinT is the port's own trunk, which the JAX package does not have
    assert set(tbb.model_dict) - {"SwinT"} == set(jbb.model_dict)
    assert {k: v for k, v in tbb.feat_dims.items() if k != "SwinT"} == \
        jbb.feat_dims
    for name, dim in tbb.feat_dims.items():
        size = {"Conv4S": 28, "Conv3": 100}.get(
            name, 84 if "Conv" in name else 224)
        assert tbb.model_dict[name]().out_dim(size, size) == dim
    # the regression trunks build and carry the reference's names
    assert [k for k, _ in tbb.model_dict["Conv3"]().named_parameters()] == [
        f"layer{i}.{p}" for i in (1, 2, 3) for p in ("weight", "bias")]
    assert [k for k, _ in tbb.model_dict["MLP2"]().named_parameters()] == [
        f"layer{i}.{p}" for i in (1, 2) for p in ("weight", "bias")]
    for name, (c, h, w) in tbb.np_feat_shapes.items():
        assert jbb.np_feat_shapes[name] == (h, w, c)
        size = 28 if "S" in name else 84
        assert getattr(tbb, name)().out_chw(size, size) == (c, h, w)
