"""The port's Woodbury route of the exact GP (gp/low_rank.py, the kernels'
`low_rank`, ExactGP's routing and force_dense) against the JAX package's
gp/low_rank.py and its dense route, on the CPU.

Tolerances: woodbury_mll and woodbury_posterior within 1e-5 of the JAX
functions and of the port's own dense route at N=256, D=32; routing
decisions equal to JAX's _use_low_rank. Two measured f32 effects set how
each comparison is made:

  * the JAX mll is held at 1e-5 relative to its size (about 4.5): the JAX
    package's dot of diff with itself sums 256 terms in sequence on the
    CPU and lands 7e-4 from the float64 value, 1.3e-5 in the mll, while
    the port's lands within 3e-7 of float64;
  * the dense route runs in float64 as the exact value: in float32 its
    N x N factor (cond(K) about 2e2 here) puts the posterior mean 1.3e-5
    from float64, the Woodbury route 2e-7 (both packages).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu.gp import exact as jexact
from deep_kernel_transfer_tpu.gp import kernels as jkernels
from deep_kernel_transfer_tpu.gp import low_rank as jlr
from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu_torch.gp import ExactGP, GaussianLikelihood
from deep_kernel_transfer_tpu_torch.gp import kernels as tkernels
from deep_kernel_transfer_tpu_torch.gp import low_rank as tlr
from deep_kernel_transfer_tpu_torch.gp.exact import init_batched
from deep_kernel_transfer_tpu_torch.methods import DKT
from deep_kernel_transfer_tpu_torch.models import ConvNet
from deep_kernel_transfer_tpu_torch.utils.convert import dkt_params_from_jax
from torch_test_threads import one_thread  # noqa: F401

N, D, M = 256, 32, 40
NOISE = 0.1


def _data(n=N, d=D, m=M, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.randn(n + m, d).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y = np.where(rng.rand(n) < 0.3, 1.0, -1.0).astype(np.float32) - 0.05
    return z[:n], y, z[n:]


def _dense(s):
    """The dense route of a cossim GP with outputscale s, float64."""
    spec = ExactGP(tkernels.make_kernel("cossim"),
                   GaussianLikelihood(trainable=False, fixed_noise=NOISE),
                   force_dense=True)
    params = spec.init(device="cpu")
    params["kernel"]["raw_outputscale"] = tkernels.inv_softplus(
        torch.tensor(s, dtype=torch.float64))
    params["mean"]["constant"] = params["mean"]["constant"].double()
    return spec, params


@pytest.mark.parametrize("s", [0.7, 2.3])
def test_woodbury_mll_matches_jax_and_dense(s):
    z, diff, _ = _data()
    want = float(jlr.woodbury_mll(jnp.asarray(z), jnp.asarray(diff), s, NOISE))
    got = float(tlr.woodbury_mll(torch.from_numpy(z), torch.from_numpy(diff),
                                 s, NOISE))
    spec, params = _dense(s)
    dense = float(spec.mll(params, torch.from_numpy(z).double(),
                           torch.from_numpy(diff).double()))
    assert abs(got - want) < 1e-5 * abs(want)
    assert abs(got - dense) < 1e-5


@pytest.mark.parametrize("full", [False, True])
def test_woodbury_posterior_matches_jax_and_dense(full):
    z, diff, zq = _data()
    s = 1.3
    want = jlr.woodbury_posterior(jnp.asarray(z), jnp.asarray(diff),
                                  jnp.asarray(zq), s, NOISE,
                                  full_covariance=full)
    got = tlr.woodbury_posterior(torch.from_numpy(z), torch.from_numpy(diff),
                                 torch.from_numpy(zq), s, NOISE,
                                 full_covariance=full)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-5
    # the dense route's posterior of the same GP (constant mean 0)
    spec, params = _dense(s)
    dense = spec.posterior(params, *(torch.from_numpy(a).double()
                                     for a in (z, diff, zq)),
                           full_covariance=full)
    assert (got[0] - dense.mean).abs().max() < 1e-5
    assert (torch.clamp(got[1], min=1e-10) - dense.variance).abs().max() < 1e-5
    if full:
        assert (got[2] - dense.covariance).abs().max() < 1e-5


@pytest.mark.parametrize("kind", ["linear", "cossim", "bncossim", "poli1"])
def test_low_rank_matches_jax_and_apply(kind):
    """Each low-rank kernel's (s, Phi(x)) equals the JAX one, and
    s Phi Phi^T is the kernel's Gram; per-way params [W] broadcast."""
    x = _data(n=20, d=6)[0]
    tk, jk = tkernels.make_kernel(kind), jkernels.make_kernel(kind)
    tp = tk.init("cpu")
    for leaf in ("raw_outputscale",):
        tp[leaf] = torch.tensor(0.3)
    if "raw_offset" in tp["base"]:
        tp["base"]["raw_offset"] = torch.tensor(-0.4)
    if "raw_variance" in tp["base"]:
        tp["base"]["raw_variance"] = torch.tensor(0.2)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    s, phi = tk.low_rank(tp, torch.from_numpy(x))
    js, jphi = jk.low_rank(jp, jnp.asarray(x))
    assert abs(float(s) - float(js)) < 1e-6
    assert np.abs(phi.numpy() - np.asarray(jphi)).max() < 1e-6
    gram = tk.apply(tp, torch.from_numpy(x), torch.from_numpy(x))
    assert (s * phi @ phi.T - gram).abs().max() < 1e-5
    # per-way parameters against a shared input: [W, N, D'] features
    tw = jax.tree.map(lambda t: t.expand(3).clone(), tp)
    sw, phiw = tk.low_rank(tw, torch.from_numpy(x)[None])
    assert sw.shape == (3,) and phiw.shape[-2] == 20
    assert tkernels.make_kernel("rbf").low_rank is None


@pytest.mark.parametrize("env", [None, "1"])
@pytest.mark.parametrize("n,d", [(100, 64), (128, 64), (256, 1600)])
@pytest.mark.parametrize("kind", ["bncossim", "linear", "poli1", "rbf"])
def test_routing_matches_jax(monkeypatch, kind, n, d, env):
    """The route at (N, D) equals the JAX ExactGP's, and DKT reads
    DKT_GP_FORCE_DENSE once, at construction, as the JAX DKT does."""
    if env is None:
        monkeypatch.delenv("DKT_GP_FORCE_DENSE", raising=False)
    else:
        monkeypatch.setenv("DKT_GP_FORCE_DENSE", env)
    x = np.zeros((n, d), np.float32)
    jm = JDKT(jbb.ConvNetS(depth=2), 5, 1, kind)
    tm = DKT(ConvNet(2, first_channel=True), 5, 1, kind, device="cpu")
    assert tm.spec.force_dense == jm.gp.force_dense == (env == "1")
    jp = jm.gp.init(jax.random.PRNGKey(0))
    tp = tm.spec.init(device="cpu")
    want = jm.gp._use_low_rank(jp, jnp.asarray(x))
    assert tm.spec._use_low_rank(tp, torch.from_numpy(x)) == want
    if kind in ("bncossim", "linear") and env is None:
        assert want == (2 * d <= n)


def test_routed_batched_ways_match_dense():
    """The DKT layout: per-way params [W], shared inputs [B, 1, N, D]: the
    routed mll and posterior equal the dense ones."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 1, 96, 16).astype(np.float32))
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = torch.from_numpy(np.where(rng.rand(4, 96) < 0.25, 1.0, -1.0)
                         .astype(np.float32))
    lik = GaussianLikelihood(trainable=False, fixed_noise=NOISE)
    routed = ExactGP(tkernels.make_kernel("linear"), lik, assume_pd=True)
    dense = routed._replace(force_dense=True)
    params = init_batched(routed, 4, device="cpu")
    params["kernel"]["raw_outputscale"] = torch.tensor([0.1, -0.5, 0.8, 0.0])
    params["kernel"]["base"]["raw_variance"] = torch.tensor([0.3, 0.0, -0.2,
                                                            0.5])
    params["mean"]["constant"] = torch.tensor([0.1, -0.2, 0.0, 0.05])
    assert routed._use_low_rank(params, x) and not dense._use_low_rank(params,
                                                                       x)
    assert (routed.mll(params, x, y) - dense.mll(params, x, y)).abs().max() \
        < 1e-5
    q = x[..., :7, :]
    a, b = routed.posterior(params, x, y, q), dense.posterior(params, x, y, q)
    assert a.mean.shape == (2, 4, 7)
    assert (a.mean - b.mean).abs().max() < 1e-5
    assert (a.variance - b.variance).abs().max() < 1e-5


def test_routed_dkt_logits_match_jax(monkeypatch):
    """A DKT whose support set routes (Conv4S features, D=64, at N=130 >=
    2D) scores like the JAX DKT on the same weights and episodes."""
    monkeypatch.delenv("DKT_GP_FORCE_DENSE", raising=False)
    way, shot, query, px = 5, 26, 2, 16
    x = np.random.RandomState(0).randint(
        0, 256, (2, way, shot + query, px, px, 3)).astype(np.uint8)
    jm = JDKT(jbb.ConvNetS(depth=4), way, shot, "bncossim",
              feature_dtype="float32")
    state = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[0]))
    tm = DKT(ConvNet(4, first_channel=True), way, shot, "bncossim",
             feature_dtype="float32", device="cpu").init(torch.from_numpy(x[0]))
    dkt_params_from_jax(jax.tree.map(np.asarray, state.params), tm, px)
    z = torch.zeros(way * shot, 64)
    assert tm.spec._use_low_rank(tm.gp.tree(), z)
    assert jm.gp._use_low_rank(state.params["gp"], jnp.zeros((way * shot, 64)))
    want = np.asarray(jm.batch_logits(state.params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.batch_logits(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, way * query, way)
    assert np.abs(got - want).max() < 1e-4


def test_force_dense_from_env_values(monkeypatch):
    for value, on in (("", False), ("0", False), ("FALSE", False),
                      (" off ", False), ("1", True), ("yes", True)):
        monkeypatch.setenv("DKT_GP_FORCE_DENSE", value)
        assert ExactGP.force_dense_from_env() is on
        assert jexact.ExactGP.force_dense_from_env() is on
