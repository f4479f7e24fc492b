"""The rest of the port's DKT kernel zoo (rbf, matern, poli1, poli2 in
deep_kernel_transfer_tpu_torch/gp/kernels.py, and the regression track's
spectral mixture through the engine) against the JAX package's,
on the same numpy inputs: the Gram, the MLL and its gradients (in the
inputs and in every hyperparameter, lengthscale and offset included), the
posterior mean and variance, at N in {25, 85, 100} with D = N + 3 (the
JAX engine's dense route, and full-rank Grams for poli1). Then a DKT(rbf)
loss on weights carried over from the JAX package, the plain route that
rbf, matern and poli take under use_fused_mll=True, and the lengthscale
telemetry.

Tolerances: forward 1e-5 absolute; gradients 2e-2 of each gradient's
largest entry; the DKT loss 1e-4 relative (f32 trunk).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu.gp import ExactGP as JExactGP
from deep_kernel_transfer_tpu.gp import GaussianLikelihood as JLik
from deep_kernel_transfer_tpu.gp import kernels as jkernels
from deep_kernel_transfer_tpu.gp import make_kernel as jmake
from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu_torch.gp import ExactGP, GaussianLikelihood
from deep_kernel_transfer_tpu_torch.gp import kernels as tkernels
from deep_kernel_transfer_tpu_torch.methods import DKT, dkt as tdkt
from deep_kernel_transfer_tpu_torch.models import ConvNet
from deep_kernel_transfer_tpu_torch.utils.convert import dkt_params_from_jax
from torch_test_threads import one_thread  # noqa: F401

KINDS = ["rbf", "matern", "poli1", "poli2"]
SIZES = [25, 85, 100]
_BASE = {"rbf": "raw_lengthscale", "matern": "raw_lengthscale",
         "poli1": "raw_offset", "poli2": "raw_offset"}


def _gps(kind):
    j = JExactGP(jmake(kind), JLik(trainable=False, fixed_noise=0.1))
    t = ExactGP(tkernels.make_kernel(kind),
                GaussianLikelihood(trainable=False, fixed_noise=0.1))
    return j, t


def _params(kind, seed=3):
    rng = np.random.RandomState(seed)
    u = lambda: np.float32(rng.uniform(-0.5, 0.5))
    return {"mean": {"constant": u()},
            "kernel": {"raw_outputscale": u(), "base": {_BASE[kind]: u()}},
            "likelihood": {}}


def _data(n, m=15, seed=0):
    d = n + 3
    rng = np.random.RandomState(seed)
    x = (rng.randn(n + m, d) / np.sqrt(d)).astype(np.float32)
    y = np.sign(rng.randn(n)).astype(np.float32)
    return x[:n], y, x[n:]


def _torch_tree(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, grad) for k, v in tree.items()}
    return torch.tensor(tree, requires_grad=grad)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix: tree}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-8))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_gram(kind, n):
    jgp, tgp = _gps(kind)
    p = _params(kind)
    x, _, xq = _data(n)
    want = jgp.kernel.apply(jax.tree.map(jnp.asarray, p["kernel"]),
                            jnp.asarray(x), jnp.asarray(xq))
    got = tgp.kernel.apply(_torch_tree(p["kernel"]), torch.from_numpy(x),
                           torch.from_numpy(xq))
    assert got.shape == (n, 15)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
    # the diagonal the posterior variance takes
    diag = tgp.kernel.diag(_torch_tree(p["kernel"]), torch.from_numpy(xq))
    full = jgp.kernel.apply(jax.tree.map(jnp.asarray, p["kernel"]),
                            jnp.asarray(xq), jnp.asarray(xq))
    assert np.abs(diag.numpy() - np.diagonal(np.asarray(full))).max() < 1e-5


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_mll_value_and_grads(kind, n):
    jgp, tgp = _gps(kind)
    p = _params(kind)
    x, y, _ = _data(n)
    jv, (jgp_, jgx) = jax.value_and_grad(
        lambda p, x: jgp.mll(p, x, jnp.asarray(y)), argnums=(0, 1))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = _torch_tree(p, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    tv = tgp.mll(tp, tx, torch.from_numpy(y))
    tv.backward()
    assert abs(tv.item() - float(jv)) < 1e-5
    assert _rel(tx.grad.numpy(), jgx) < 2e-2
    jl = _leaves(jgp_)
    assert f"kernel.base.{_BASE[kind]}." in jl
    for path, leaf in _leaves(tp).items():
        assert _rel(leaf.grad.numpy(), jl[path]) < 2e-2, path


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_posterior_mean_and_variance(kind, n):
    jgp, tgp = _gps(kind)
    p = _params(kind)
    x, y, xq = _data(n)
    want = jgp.posterior(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                         jnp.asarray(y), jnp.asarray(xq))
    got = tgp.posterior(_torch_tree(p), torch.from_numpy(x),
                        torch.from_numpy(y), torch.from_numpy(xq))
    assert got.mean.shape == got.variance.shape == (15,)
    assert np.abs(got.mean.numpy() - np.asarray(want.mean)).max() < 1e-5
    assert np.abs(got.variance.numpy()
                  - np.asarray(want.variance)).max() < 1e-5


@pytest.mark.parametrize("kind", KINDS)
def test_way_batched_lengthscale_and_offset(kind):
    """Per-way parameters [W] scale each way's Gram: one batched call
    equals W calls with the scalar parameters."""
    _, tgp = _gps(kind)
    ps = [_params(kind, seed) for seed in range(3)]
    stacked = jax.tree.map(lambda *a: np.stack(a), *ps)
    x, y, xq = _data(25)
    x, xq = torch.from_numpy(x), torch.from_numpy(xq)
    yw = torch.from_numpy(np.stack([y, -y, y]))
    got = tgp.posterior(_torch_tree(stacked), x, yw, xq)
    for w, p in enumerate(ps):
        one = tgp.posterior(_torch_tree(p), x, yw[w], xq)
        assert torch.allclose(got.mean[w], one.mean, atol=1e-6)
        assert torch.allclose(got.variance[w], one.variance, atol=1e-6)


def test_spectral_still_raises(monkeypatch):
    """The spectral mixture through the exact GP with a trainable noise:
    the MLL and its gradients, the posterior mean and variance, against
    the JAX engine (its sq_dist replaced by the exact elementwise sum that
    gpytorch and the port use; tests/test_torch_regression.py says why).
    The name is kept from when the port refused the kernel."""
    monkeypatch.setattr(jkernels, "sq_dist", lambda a, b: jnp.sum(
        jnp.square(a[:, None, :] - b[None, :, :]), axis=-1))
    d = 6
    jgp = JExactGP(jmake("spectral", dim=d), JLik(trainable=True))
    tgp = ExactGP(tkernels.make_kernel("spectral", dim=d),
                  GaussianLikelihood(trainable=True))
    rng = np.random.RandomState(8)
    p = {"mean": {"constant": np.float32(0.1)},
         "kernel": {"raw_weights": rng.uniform(-1, 1, 4).astype(np.float32),
                    "raw_means": rng.randn(4, d).astype(np.float32),
                    "raw_scales": rng.randn(4, d).astype(np.float32)},
         "likelihood": {"raw_noise": np.float32(-1.0)}}
    x = (rng.randn(25, d) * 0.1).astype(np.float32)
    xq = (rng.randn(9, d) * 0.1).astype(np.float32)
    y = np.sin(3 * x[:, 0]).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda p: jgp.mll(p, jnp.asarray(x),
                                                  jnp.asarray(y)))(
        jax.tree.map(jnp.asarray, p))
    tp = _torch_tree(p, grad=True)
    tv = tgp.mll(tp, torch.from_numpy(x), torch.from_numpy(y))
    tv.backward()
    assert abs(tv.item() - float(jv)) < 1e-5
    jl = _leaves(jg)
    for path, leaf in _leaves(tp).items():
        assert _rel(leaf.grad.numpy(), jl[path]) < 2e-2, path
    want = jgp.posterior(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                         jnp.asarray(y), jnp.asarray(xq))
    got = tgp.posterior(_torch_tree(p), torch.from_numpy(x),
                        torch.from_numpy(y), torch.from_numpy(xq))
    assert np.abs(got.mean.numpy() - np.asarray(want.mean)).max() < 1e-5
    assert np.abs(got.variance.numpy()
                  - np.asarray(want.variance)).max() < 1e-5


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_matern_nu(nu):
    from deep_kernel_transfer_tpu.gp.kernels import matern_kernel

    """Every nu against the JAX kernel, 1e-5 off the diagonal. On the
    diagonal the distance is the sqrt of the rounding left by ||a||^2 +
    ||b||^2 - 2 a.b (up to about 1e-3 here, in either framework), which
    exp(-d) of nu = 0.5 passes on to first order; there both stay within
    1e-3 of k(x, x) = 1."""
    x = _data(25)[0]
    k, jk = tkernels.matern_kernel(nu), matern_kernel(nu)
    got = k.apply(k.init(), torch.from_numpy(x), torch.from_numpy(x)).numpy()
    want = np.asarray(jk.apply(jk.init(None), jnp.asarray(x),
                               jnp.asarray(x)))
    off = ~np.eye(25, dtype=bool)
    assert np.abs(got - want)[off].max() < 1e-5
    for g in (got, want):
        assert np.abs(np.diagonal(g) - 1.0).max() < 1e-3
    with pytest.raises(ValueError):
        tkernels.matern_kernel(3.5)


def _episodes(seed=0, b=2):
    return np.random.RandomState(seed).randint(
        0, 256, (b, 5, 5, 16, 16, 3)).astype(np.uint8)


def test_dkt_rbf_loss_matches_jax():
    x = _episodes()
    jm = JDKT(jbb.ConvNet(depth=2), 5, 2, "rbf", feature_dtype="float32")
    state = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    params = jax.tree.map(np.asarray, state.params)
    params["gp"]["kernel"]["base"]["raw_lengthscale"] = np.linspace(
        -0.4, 0.4, 5).astype(np.float32)
    tm = DKT(ConvNet(2), 5, 2, "rbf", feature_dtype="float32",
             device="cpu").init(torch.from_numpy(x[0]))
    dkt_params_from_jax(params, tm, 16)
    want = float(jm.batch_loss(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(x)))
    got, _ = tm.batch_loss_train(torch.from_numpy(x))
    assert abs(got.item() - want) < 1e-4 * abs(want)
    metrics = tm.train_step(torch.from_numpy(x))
    assert set(metrics) == {"loss", "outputscale", "lengthscale", "noise"}
    assert abs(float(metrics["lengthscale"]) - float(np.mean(
        np.log1p(np.exp(params["gp"]["kernel"]["base"]["raw_lengthscale"]))))
    ) < 1e-3  # one gp_lr step


@pytest.mark.parametrize("kind", KINDS)
def test_fused_setting_takes_the_plain_route(kind, monkeypatch):
    """The fused kernel is linear-family only: under use_fused_mll=True the
    other kernels never call it and give the plain route's loss."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("fused_linear_mll called for a kernel it does "
                             "not support")

    monkeypatch.setattr(tdkt, "fused_linear_mll", no_kernel)
    x = torch.from_numpy(_episodes(b=1))
    losses = []
    for fused in (True, False):
        tm = DKT(ConvNet(2), 5, 2, kind, feature_dtype="float32",
                 use_fused_mll=fused, device="cpu").init(
                     x[0], torch.Generator().manual_seed(0))
        losses.append(tm.batch_loss_train(x)[0].item())
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
