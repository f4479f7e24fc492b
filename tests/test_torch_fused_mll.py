"""The port's fused GP-MLL (deep_kernel_transfer_tpu_torch/ops/fused_mll.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On CPU tensors the port's wrapper takes its plain torch forward (the
kernel's algorithm: K identity-padded to a multiple of 32, Cholesky,
explicit inverse, products) with the closed-form backward, which takes
K^-1 and the Gram from the forward's residuals; the CUDA kernel itself is
held to that plain version on the card by chip_smoke.py. Tolerances are
those of the JAX package's own kernel test (tests/test_pallas_mll.py:39,45):
forward 1e-5 absolute, gradients 2e-2 relative to each gradient's largest
entry. Each episode's own scales [B, W] and diffs [B, W, N] (test-time
adaptation) are held to jax.vmap of the Pallas kernel over episodes.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from deep_kernel_transfer_tpu.ops.pallas import fused_mll as jfm
from deep_kernel_transfer_tpu_torch.ops import fused_mll as tfm
from torch_test_threads import one_thread  # noqa: F401

NOISE = 0.1
# (N, D), B=3 episodes, W=5 ways; (105, 768): Swin-T's features at the
# benchmark's 5w5s16q episodes
SHAPES = [(30, 96), (100, 256), (128, 160), (105, 768)]


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run pl.pallas_call in interpret mode; the JAX package is unchanged."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(n, d, b=3, w=5, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.randn(b, n, d).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    labels = np.arange(n) % w
    diffs = np.where(labels[None, :] == np.arange(w)[:, None], 1.0, -1.0)
    diffs = (diffs - 0.13).astype(np.float32)  # non-zero constant mean
    scales = np.linspace(0.4, 1.5, w).astype(np.float32)
    return z, diffs, scales


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-8))


@pytest.mark.parametrize("n,d", SHAPES)
def test_forward_matches_pallas_kernel(interpret_pallas, n, d):
    z, diffs, scales = _inputs(n, d)
    want = np.asarray(jfm.fused_linear_mll(jnp.asarray(z), jnp.asarray(diffs),
                                           jnp.asarray(scales), n, NOISE))
    args = [torch.from_numpy(a) for a in (z, diffs, scales)]
    got = tfm.fused_linear_mll(*args, n, NOISE).numpy()
    plain = tfm.fused_linear_mll_plain(*args, n, NOISE).numpy()
    assert got.shape == want.shape == (3, 5)
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(plain - want).max() < 1e-5


@pytest.mark.parametrize("n,d", SHAPES)
def test_backward_matches_pallas_vjp(interpret_pallas, n, d):
    z, diffs, scales = _inputs(n, d)
    want = jax.grad(
        lambda z, d_, s: -jnp.sum(jfm.fused_linear_mll(z, d_, s, n, NOISE)),
        argnums=(0, 1, 2))(jnp.asarray(z), jnp.asarray(diffs),
                           jnp.asarray(scales))
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (z, diffs, scales)]
    got = torch.autograd.grad(-tfm.fused_linear_mll(*args, n, NOISE).sum(),
                              args)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) < 2e-2


@pytest.mark.parametrize("n,d", SHAPES)
def test_residuals_match_pallas_kernel(interpret_pallas, n, d):
    """The plain forward's residuals against the Pallas kernel's: L^-1
    against the inverse of its factor, alpha, and the Gram."""
    z, diffs, scales = _inputs(n, d)
    _, chol, alpha = jfm._fwd_impl(jnp.asarray(z), jnp.asarray(diffs),
                                   jnp.asarray(scales), n, NOISE, 1e-6)
    chol = np.asarray(chol, np.float64)[:, :, :n, :n]
    _, linv, got_alpha, gram = tfm._forward_plain(
        *(torch.from_numpy(a) for a in (z, diffs, scales)), NOISE, 1e-6)
    assert linv.shape == (3, 5, n, n) and gram.shape == (3, n, n)
    assert _rel(linv.numpy(), np.linalg.inv(chol)) < 1e-5
    assert _rel(got_alpha.numpy(), np.asarray(alpha)[:, :, :n]) < 1e-5
    z64 = z.astype(np.float64)
    assert _rel(gram.numpy(), z64 @ z64.transpose(0, 2, 1)) < 1e-6


@pytest.mark.parametrize("n", [30, 100])
def test_identity_pad_adds_nothing(n):
    """K padded with an identity block to the kernel's size gives the same
    mll, L^-1 and alpha as K unpadded, relative to each one's largest entry:
    in float64 to rounding, in float32 within the forward tolerance (the
    factor's blocking differs between the two sizes)."""
    z, diffs, scales = (torch.from_numpy(a) for a in _inputs(n, 64))
    assert tfm.padded_size(n) == 32 * -(-n // 32)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        args = (tfm.dot_f32(z.to(dtype), z.to(dtype)), diffs.to(dtype),
                scales.to(dtype), NOISE + 1e-6)
        for a, b in zip(tfm._residuals(*args, n),
                        tfm._residuals(*args, tfm.padded_size(n))):
            assert _rel(a.numpy(), b.numpy()) < tol


@pytest.mark.parametrize("fn", ["fused_linear_mll", "fused_linear_mll_plain"])
def test_gradcheck_float64(fn):
    """Finite differences in float64 against the closed-form backward
    (fused_linear_mll on CPU tensors) and torch's own autograd (plain)."""
    z, diffs, scales = _inputs(12, 16, b=2, w=3, seed=1)
    args = [torch.from_numpy(a).double().requires_grad_(True)
            for a in (z, diffs, scales)]
    f = getattr(tfm, fn)
    assert torch.autograd.gradcheck(lambda *a: f(*a, 12, NOISE), args)


def test_cpu_tensors_never_launch_the_kernel():
    z, diffs, scales = (torch.from_numpy(a) for a in _inputs(30, 96))
    before = tfm.fused_linear_mll.launches
    tfm.fused_linear_mll(z, diffs, scales, 30, NOISE)
    assert tfm.fused_linear_mll.launches == before


@pytest.mark.parametrize("kind", ["linear", "cossim", "bncossim", "rbf",
                                  "matern", "poli1", "Cossim"])
@pytest.mark.parametrize("n", [85, 128, 129])
def test_supports_matches_jax(kind, n):
    assert tfm.supports(kind, n) == jfm.supports(kind, n)


def _per_episode_inputs(n, d, b=3, w=5, seed=0):
    """Each episode's own scales [B, W] and diffs [B, W, N]."""
    z, diffs, scales = _inputs(n, d, b, w, seed)
    rng = np.random.RandomState(seed + 1)
    scales_b = (scales[None] * rng.uniform(0.5, 2.0, (b, w))).astype(
        np.float32)
    diffs_b = (diffs[None] - rng.uniform(-0.3, 0.3, (b, w, 1))).astype(
        np.float32)
    return z, diffs_b, scales_b


def _jax_per_episode(n):
    """The JAX kernel vmapped over episodes with batched scales and diffs:
    [B, W]."""
    def one(z, d_, s):
        return jfm.fused_linear_mll(z[None], d_, s, n, NOISE)[0]
    return jax.vmap(one)


@pytest.mark.parametrize("n,d", [(25, 64), (100, 256)])
def test_per_episode_params_match_vmapped_pallas_kernel(interpret_pallas, n,
                                                        d):
    """scales [B, W] and diffs [B, W, N] against jax.vmap of the Pallas
    kernel over episodes: forward 1e-5 absolute; the gradients in z, diffs
    and scales 2e-2 relative, each of the caller's shape."""
    z, diffs, scales = _per_episode_inputs(n, d)
    jargs = [jnp.asarray(a) for a in (z, diffs, scales)]
    want = np.asarray(_jax_per_episode(n)(*jargs))
    want_g = jax.grad(lambda *a: -jnp.sum(_jax_per_episode(n)(*a)),
                      argnums=(0, 1, 2))(*jargs)
    for fn in (tfm.fused_linear_mll, tfm.fused_linear_mll_plain):
        args = [torch.from_numpy(a).requires_grad_(True)
                for a in (z, diffs, scales)]
        got = fn(*args, n, NOISE)
        assert got.shape == want.shape == (3, 5)
        assert np.abs(got.detach().numpy() - want).max() < 1e-5
        grads = torch.autograd.grad(-got.sum(), args)
        for g, w, a in zip(grads, want_g, args):
            assert g.shape == a.shape
            assert _rel(g.numpy(), np.asarray(w)) < 2e-2


def test_shared_params_equal_repeated_per_episode_params():
    """The shared form [W], [W, N] and the per-episode form with every
    episode's rows equal give the same mll and, summed over episodes, the
    same gradients."""
    z, diffs, scales = (torch.from_numpy(a) for a in _inputs(30, 96))
    shared = [t.clone().requires_grad_(True) for t in (z, diffs, scales)]
    per_ep = [z.clone().requires_grad_(True),
              diffs.expand(3, -1, -1).clone().requires_grad_(True),
              scales.expand(3, -1).clone().requires_grad_(True)]
    a = tfm.fused_linear_mll(*shared, 30, NOISE)
    b = tfm.fused_linear_mll(*per_ep, 30, NOISE)
    assert torch.allclose(a, b, rtol=0, atol=1e-6)
    ga = torch.autograd.grad(a.sum(), shared)
    gb = torch.autograd.grad(b.sum(), per_ep)
    assert torch.allclose(ga[0], gb[0], rtol=1e-5, atol=1e-6)
    assert torch.allclose(ga[1], gb[1].sum(0), rtol=1e-5, atol=1e-6)
    assert torch.allclose(ga[2], gb[2].sum(0), rtol=1e-5, atol=1e-6)


def test_gradcheck_per_episode_float64():
    z, diffs, scales = _per_episode_inputs(12, 16, b=2, w=3, seed=2)
    args = [torch.from_numpy(a).double().requires_grad_(True)
            for a in (z, diffs, scales)]
    assert torch.autograd.gradcheck(
        lambda *a: tfm.fused_linear_mll(*a, 12, NOISE), args)


def test_rejects_mismatched_shapes():
    z, diffs, scales = (torch.from_numpy(a) for a in _inputs(30, 96))
    with pytest.raises(ValueError):
        tfm.fused_linear_mll(z, diffs[:, :29], scales, 30, NOISE)
    with pytest.raises(ValueError):
        tfm.fused_linear_mll(z, diffs, scales, 29, NOISE)
    with pytest.raises(ValueError):  # per-episode rows for 2 of 3 episodes
        tfm.fused_linear_mll(z, diffs.expand(2, -1, -1), scales, 30, NOISE)
    with pytest.raises(ValueError):
        tfm.fused_linear_mll(z, diffs, scales.expand(2, -1), 30, NOISE)
