"""The port's exact-GP engine (deep_kernel_transfer_tpu_torch/gp) against
the JAX package's (deep_kernel_transfer_tpu/gp) on the same numpy inputs.

Sizes keep 2D > N, where the JAX engine takes its dense route too (the
port has no Woodbury route yet). Forward values agree to 1e-5 absolute,
gradients to 2e-2 of each gradient's largest entry (f32 on both sides; the
sums run in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu.gp import ExactGP as JExactGP
from deep_kernel_transfer_tpu.gp import GaussianLikelihood as JLik
from deep_kernel_transfer_tpu.gp import make_kernel as jmake
from deep_kernel_transfer_tpu.gp import exact as jexact
from deep_kernel_transfer_tpu.gp import kernels as jkernels
from deep_kernel_transfer_tpu_torch.gp import ExactGP, GaussianLikelihood
from deep_kernel_transfer_tpu_torch.gp import exact as texact
from deep_kernel_transfer_tpu_torch.gp import kernels as tkernels
from torch_test_threads import one_thread  # noqa: F401

SIZES = [25, 85, 100]
KINDS = ["bncossim", "linear"]


def _gps(kind, noise=0.1):
    j = JExactGP(jmake(kind), JLik(trainable=False, fixed_noise=noise))
    t = ExactGP(tkernels.make_kernel(kind),
                GaussianLikelihood(trainable=False, fixed_noise=noise))
    return j, t


def _params(kind, w=None):
    """numpy params tree; leaves [w] when w is given."""
    shape = () if w is None else (w,)
    rng = np.random.RandomState(3)
    p = {"mean": {"constant": rng.uniform(-0.3, 0.3, shape).astype(np.float32)},
         "kernel": {"raw_outputscale":
                    rng.uniform(-0.5, 0.5, shape).astype(np.float32),
                    "base": {}},
         "likelihood": {}}
    if kind == "linear":
        p["kernel"]["base"]["raw_variance"] = rng.uniform(
            -0.5, 0.5, shape).astype(np.float32)
    return p


def _data(n, d, m=0, w=None, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n + m, d) / np.sqrt(d)).astype(np.float32)
    ys = (n,) if w is None else (w, n)
    y = np.sign(rng.randn(*ys)).astype(np.float32)
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
def test_mll_value_and_grads(kind, n):
    jgp, tgp = _gps(kind)
    p = _params(kind)
    x, y, _ = _data(n, n // 2 + 3)
    jv, (jgp_, jgx) = jax.value_and_grad(
        lambda p, x: jgp.mll(p, x, jnp.asarray(y)), argnums=(0, 1))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = _torch_tree(p, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    tv = tgp.mll(tp, tx, torch.from_numpy(y))
    tv.backward()
    assert abs(tv.item() - float(jv)) < 1e-5
    assert _rel(tx.grad.numpy(), jgx) < 2e-2
    for path, leaf in _leaves(tp).items():
        assert _rel(leaf.grad.numpy(), _leaves(jgp_)[path]) < 2e-2, path


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_sum_mll_over_ways(kind, n):
    jgp, tgp = _gps(kind)
    p = _params(kind, w=5)
    x, y, _ = _data(n, n // 2 + 3, w=5)
    want = jexact.sum_mll(jgp, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                          jnp.asarray(y))
    got = texact.sum_mll(tgp, _torch_tree(p), torch.from_numpy(x),
                         torch.from_numpy(y))
    assert abs(float(got) - float(want)) < 5e-5  # a sum of 5 MLLs


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_posterior_mean_and_variance(kind, n):
    jgp, tgp = _gps(kind)
    p = _params(kind)
    x, y, xq = _data(n, n // 2 + 3, m=15)
    want = jgp.posterior(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                         jnp.asarray(y), jnp.asarray(xq))
    got = tgp.posterior(_torch_tree(p), torch.from_numpy(x),
                        torch.from_numpy(y), torch.from_numpy(xq))
    assert got.mean.shape == got.variance.shape == (15,)
    assert np.abs(got.mean.numpy() - np.asarray(want.mean)).max() < 1e-5
    assert np.abs(got.variance.numpy() - np.asarray(want.variance)).max() < 1e-5


def test_posterior_full_covariance():
    jgp, tgp = _gps("bncossim")
    p = _params("bncossim")
    x, y, xq = _data(25, 20, m=7)
    want = jgp.posterior(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                         jnp.asarray(y), jnp.asarray(xq), full_covariance=True)
    got = tgp.posterior(_torch_tree(p), torch.from_numpy(x),
                        torch.from_numpy(y), torch.from_numpy(xq),
                        full_covariance=True)
    assert np.abs(got.covariance.numpy() - np.asarray(want.covariance)).max() < 1e-5
    assert np.abs(got.variance.numpy() - np.asarray(want.variance)).max() < 1e-5


def test_batched_posterior_over_ways():
    jgp, tgp = _gps("linear")
    p = _params("linear", w=5)
    x, y, xq = _data(25, 20, m=10, w=5)
    want = jexact.batched_posterior(jgp, jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(xq))
    got = texact.batched_posterior(tgp, _torch_tree(p), torch.from_numpy(x),
                                   torch.from_numpy(y), torch.from_numpy(xq))
    assert got.mean.shape == (5, 10)
    assert np.abs(got.mean.numpy() - np.asarray(want.mean)).max() < 1e-5
    assert np.abs(got.variance.numpy() - np.asarray(want.variance)).max() < 1e-5


def test_assume_pd_matches_jitter_search():
    """assume_pd takes one plain factorisation; on a PD Gram the result is
    the jitter search's (JAX exact.py:139-153)."""
    _, tgp = _gps("bncossim")
    p = _torch_tree(_params("bncossim"))
    x, y, _ = _data(40, 30)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    fast = tgp._replace(assume_pd=True).mll(p, x, y)
    assert float(fast) == float(tgp.mll(p, x, y))


def test_psd_safe_cholesky_jitter_per_matrix():
    """A PD matrix beside one that needs jitter: each gets its own level,
    as under the JAX package's vmap."""
    rng = np.random.RandomState(0)
    z = rng.randn(10, 3).astype(np.float32)
    singular = z @ z.T - 1e-5 * np.eye(10, dtype=np.float32)
    pd = singular + 2.0 * np.eye(10, dtype=np.float32)
    mats = np.stack([pd, singular])
    want = np.asarray(jax.vmap(jexact.psd_safe_cholesky)(jnp.asarray(mats)))
    got = texact.psd_safe_cholesky(torch.from_numpy(mats)).numpy()
    assert np.isfinite(got).all()
    # the near-singular factor amplifies rounding, so compare what each
    # factor reconstructs, and the jitter that each one added
    rec_got = got @ np.swapaxes(got, -1, -2)
    rec_want = want @ np.swapaxes(want, -1, -2)
    assert np.abs(rec_got - rec_want).max() < 1e-5
    jit_got = np.diagonal(rec_got - mats, axis1=-2, axis2=-1).mean(-1)
    jit_want = np.diagonal(rec_want - mats, axis1=-2, axis2=-1).mean(-1)
    assert abs(jit_got[0]) < 1e-6 and jit_got[1] > 5e-6
    assert np.allclose(jit_got, jit_want, rtol=0.1, atol=1e-6)


def test_psd_safe_cholesky_exhausted_is_nan():
    bad = -1e3 * np.eye(4, dtype=np.float32)
    want = np.asarray(jexact.psd_safe_cholesky(jnp.asarray(bad)))
    got = texact.psd_safe_cholesky(torch.from_numpy(bad)).numpy()
    assert np.isnan(want).any() and np.isnan(got).any()


def test_init_batched_matches_jax():
    jgp, tgp = _gps("linear")
    want = jexact.init_batched(jgp, jax.random.PRNGKey(0), 5)
    got = texact.init_batched(tgp, 5, device="cpu")
    jl, tl = _leaves(want), _leaves(got)
    assert set(jl) == set(tl)
    for k in jl:
        assert tl[k].shape == (5,)
        assert np.array_equal(tl[k].numpy(), np.asarray(jl[k]))


@pytest.mark.parametrize("init", ["init", "init_batched"])
def test_init_without_a_device_is_cuda_or_raises(init):
    """Entry points run on CUDA unless given device='cpu'."""
    _, tgp = _gps("linear")
    make = (lambda **kw: tgp.init(**kw)) if init == "init" else (
        lambda **kw: texact.init_batched(tgp, 5, **kw))
    if torch.cuda.is_available():
        leaves = _leaves(make()).values()
        assert all(t.is_cuda for t in leaves)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert all(t.device.type == "cpu"
               for t in _leaves(make(device="cpu")).values())


def test_softplus_roundtrip_matches_jax():
    y = np.array([1e-3, 0.1, 0.6931, 3.0], np.float32)
    got = tkernels.inv_softplus(torch.from_numpy(y)).numpy()
    want = np.asarray(jkernels.inv_softplus(jnp.asarray(y)))
    assert np.allclose(got, want, atol=1e-6)
    assert np.allclose(tkernels.softplus(torch.from_numpy(got)).numpy(), y,
                       atol=1e-6)


def test_kernel_registry():
    for kind in ("linear", "cossim", "bncossim", "rbf", "matern", "poli1",
                 "poli2"):
        tkernels.make_kernel(kind)
        assert (tkernels.normalizes_features(kind)
                == jkernels.normalizes_features(kind))
    # spectral builds, with the JAX registry's parameters and shapes
    spectral = tkernels.make_kernel("spectral", dim=7, num_mixtures=3)
    got = spectral.init("cpu", torch.Generator().manual_seed(0))
    want = jkernels.make_kernel("spectral", dim=7, num_mixtures=3).init(
        jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert float(got["raw_weights"].abs().max()) == 0.0
    for bad in (lambda: tkernels.make_kernel("spectral"),
                lambda: jkernels.make_kernel("spectral")):
        with pytest.raises(ValueError, match="ard_num_dims"):
            bad()
    with pytest.raises(ValueError):
        tkernels.make_kernel("nope")


def test_likelihood_noise():
    fixed = GaussianLikelihood(trainable=False, fixed_noise=0.1)
    assert fixed.init() == {} and fixed.noise({}) == 0.1
    with pytest.raises(ValueError):
        fixed.init(noise=0.2)
    free = GaussianLikelihood(trainable=True)
    p = free.init(noise=0.3)
    jp = JLik(trainable=True).init(0.3)
    assert abs(float(free.noise(p)) - float(JLik().noise(jp))) < 1e-6
    assert abs(float(free.noise(free.init())) - np.log(2.0)) < 1e-6


def test_likelihood_adds_noise_to_a_distribution():
    from deep_kernel_transfer_tpu.gp.distributions import MultivariateNormal as JMVN
    from deep_kernel_transfer_tpu_torch.gp import MultivariateNormal

    mean = np.array([0.5, -1.0, 2.0], np.float32)
    cov = np.array([[1.0, 0.2, 0.0], [0.2, 2.0, 0.1], [0.0, 0.1, 3.0]],
                   np.float32)
    var = np.diagonal(cov).copy()
    for lik, jlik in ((GaussianLikelihood(trainable=True), JLik()),
                      (GaussianLikelihood(trainable=False, fixed_noise=0.1),
                       JLik(trainable=False, fixed_noise=0.1))):
        got = lik(lik.init(), MultivariateNormal(*map(torch.from_numpy,
                                                      (mean, var, cov))))
        want = jlik(jlik.init(), JMVN(*map(jnp.asarray, (mean, var, cov))))
        assert np.allclose(got.mean.numpy(), np.asarray(want.mean))
        assert np.allclose(got.variance.numpy(), np.asarray(want.variance))
        assert np.allclose(got.covariance.numpy(), np.asarray(want.covariance))
