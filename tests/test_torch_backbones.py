"""The port's Conv4-family trunk (deep_kernel_transfer_tpu_torch/models)
against the JAX package's, on weights carried across with
utils.convert.dkt_params_from_jax.

A tiny ConvNet(depth=2) at 16 px with the bncossim head keeps the CPU time
small. BatchNorm scales, shifts and running statistics are randomised so
that eval mode is not the identity. The port flattens CHW and the JAX
package HWC; features are compared after that permutation, in float32, to
1e-5 (the convolutions sum in another order). A wrong permutation would
not show in a loss, since Z Z^T does not depend on the feature order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.methods import base as jbase
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu_torch.methods import DKT
from deep_kernel_transfer_tpu_torch.methods import base as tbase
from deep_kernel_transfer_tpu_torch.models import backbones as tbb
from deep_kernel_transfer_tpu_torch.utils.convert import (
    chw_to_hwc_perm, dkt_params_from_jax, dkt_state_from_jax)
from torch_test_threads import one_thread  # noqa: F401

B, WAY, SHOT, QUERY, PX = 2, 5, 2, 3, 16


def _randomise_bn(tree, rng):
    """Random BatchNorm scale/bias/mean/var in a JAX params tree."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "mean" or (k == "bias" and v.ndim == 1 and "scale" in tree):
            out[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
        else:
            out[k] = _randomise_bn(v, rng)
    return out


@pytest.fixture(scope="module")
def pair():
    x = np.random.RandomState(0).randint(
        0, 256, (B, WAY, SHOT + QUERY, PX, PX, 3)).astype(np.uint8)
    jm = JDKT(jbb.ConvNet(depth=2), WAY, SHOT, "bncossim",
              feature_dtype="float32")
    params = jax.tree.map(np.asarray,
                          jm.init(jax.random.PRNGKey(0), x[0]).params)
    params = {"feature": _randomise_bn(params["feature"],
                                       np.random.RandomState(1)),
              "gp": params["gp"]}
    tm = DKT(tbb.ConvNet(2), WAY, SHOT, "bncossim", feature_dtype="float32",
             device="cpu").init(torch.from_numpy(x[0]))
    dkt_params_from_jax(params, tm, PX)
    perm = chw_to_hwc_perm(*tm.feature.out_chw(PX, PX)[1:], 64)
    return dict(x=x, jm=jm, params=params, tm=tm, perm=perm,
                x_flat=x.reshape((-1, PX, PX, 3)))


def _jax_features(pair, train, ep_groups=1):
    out, stats = jbase.apply_trunk(
        pair["jm"].feature, jax.tree.map(jnp.asarray, pair["params"]["feature"]),
        jnp.asarray(pair["x_flat"]), train, dtype=jnp.float32,
        ep_groups=ep_groups)
    return np.asarray(out), stats


def _port_features(pair, train, ep_groups=1, x=None):
    x = pair["x_flat"] if x is None else x
    with torch.no_grad():
        out, stats = tbase.apply_trunk(pair["tm"].feature, torch.from_numpy(x),
                                       train, dtype=torch.float32,
                                       ep_groups=ep_groups)
    return out.numpy()[:, pair["perm"]], stats


def test_preprocess_matches_jax():
    x = np.random.RandomState(2).randint(0, 256, (4, 6, 6, 3)).astype(np.uint8)
    got = tbb.preprocess_input(torch.from_numpy(x)).numpy()
    want = np.asarray(jbb.preprocess_input(jnp.asarray(x)))
    assert np.abs(got - want).max() < 1e-6
    f = torch.randn(2, 4, 4, 3)
    assert tbb.preprocess_input(f) is f


def test_conv4_widths():
    net = tbb.Conv4()
    assert net.out_dim(84, 84) == 1600
    assert [net.trunk[i].C.weight.shape[:2] for i in range(4)] == [
        (64, 3), (64, 64), (64, 64), (64, 64)]
    std = net.trunk[1].C.weight.std().item()
    assert abs(std - np.sqrt(2.0 / (9 * 64))) < 0.01  # fan-in init


def test_state_dict_names_follow_the_reference(pair):
    names = set(pair["tm"].feature.state_dict())
    for i in range(2):
        for leaf in ("C.weight", "C.bias", "BN.weight", "BN.bias",
                     "BN.running_mean", "BN.running_var"):
            assert f"trunk.{i}.{leaf}" in names
    assert {"trunk.bn_out.weight", "trunk.bn_out.running_var"} <= names


def test_eval_features_match_jax(pair):
    want, _ = _jax_features(pair, train=False)
    got, stats = _port_features(pair, train=False)
    assert stats is None and got.shape == want.shape == (50, 1024)
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("ep_groups", [1, B])
def test_train_features_match_jax(pair, ep_groups):
    """Held to 1e-5 of the largest feature: train-mode BatchNorm divides by
    the standard deviation of one episode's 25 images, which scales up the
    convolutions' rounding differences."""
    want, _ = _jax_features(pair, train=True, ep_groups=ep_groups)
    got, _ = _port_features(pair, train=True, ep_groups=ep_groups)
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_running_stats_after_merge_match_jax(pair):
    """Per-episode statistics, averaged over the episodes, merged into the
    running averages (JAX methods/base.py:99-110)."""
    _, jstats = _jax_features(pair, train=True, ep_groups=B)
    merged = jbase.merge_stats(
        jax.tree.map(jnp.asarray, pair["params"]["feature"]), jstats)
    want = dkt_state_from_jax(
        {"feature": jax.tree.map(np.asarray, merged),
         "gp": pair["params"]["gp"]}, pair["tm"], PX)
    tm = pair["tm"]
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    try:
        _, stats = _port_features(pair, train=True, ep_groups=B)
        tbase.merge_stats(stats)
        got = tm.state_dict()
        running = [k for k in want if "running" in k]
        assert len(running) == 6
        for k in running:
            assert np.abs(got[k].numpy() - want[k]).max() < 1e-5, k
            assert not torch.equal(got[k], before[k]), k
    finally:
        tm.load_state_dict(before)


def test_grouped_batchnorm_equals_per_episode_loop():
    torch.manual_seed(0)
    bn = tbb.EpisodicBatchNorm(8)
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 1.5)
    x = torch.randn(3 * 10, 8, 4, 4)
    grouped_stats = {}
    y = bn(x, True, 3, grouped_stats)
    loop, loop_stats = [], []
    for e in range(3):
        st = {}
        loop.append(bn(x[10 * e:10 * (e + 1)], True, 1, st))
        loop_stats.append(st[bn])
    assert torch.allclose(y, torch.cat(loop), atol=1e-6)
    mean, var = grouped_stats[bn]
    assert torch.allclose(mean, torch.stack([s[0] for s in loop_stats]).mean(0),
                          atol=1e-6)
    assert torch.allclose(var, torch.stack([s[1] for s in loop_stats]).mean(0),
                          atol=1e-6)


def test_batchnorm_bf16_keeps_f32_statistics():
    """bf16 input: one-pass f32 statistics, bf16 output, close to the f32
    two-pass result."""
    torch.manual_seed(0)
    bn = tbb.EpisodicBatchNorm(6)
    x = torch.randn(20, 6, 5, 5) * 3 + 1
    s16, s32 = {}, {}
    y16 = bn(x.to(torch.bfloat16), True, 2, s16)
    y32 = bn(x.to(torch.bfloat16).float(), True, 2, s32)
    assert y16.dtype == torch.bfloat16
    assert s16[bn][0].dtype == s16[bn][1].dtype == torch.float32
    assert torch.allclose(y16.float(), y32, atol=3e-2)
    assert torch.allclose(s16[bn][1], s32[bn][1], rtol=1e-4)


def test_batchnorm_rejects_ragged_groups():
    with pytest.raises(ValueError):
        tbb.EpisodicBatchNorm(4)(torch.randn(7, 4), True, 2)
