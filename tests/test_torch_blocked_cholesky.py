"""The port's blocked Cholesky (deep_kernel_transfer_tpu_torch/ops/
blocked_cholesky.py) against the JAX package's Pallas kernel, run in
interpret mode on the CPU, on the same numpy inputs.

On CPU tensors the port's wrapper takes its plain torch version (the
kernel's tile algorithm in torch ops) with the Murray backward; the CUDA
kernel itself is held to that plain version on the card by chip_smoke.py.
Tolerances are those of the JAX package's own kernel test
(tests/test_pallas_mll.py:94,108): the factor and its reconstruction 1e-5
relative to the largest entry, gradients 2e-2 relative.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from deep_kernel_transfer_tpu.ops.pallas import blocked_cholesky as jbc
from deep_kernel_transfer_tpu_torch.ops import blocked_cholesky as tbc
from deep_kernel_transfer_tpu_torch.ops.tf32x3 import tf32x3_matmul
from torch_test_threads import one_thread  # noqa: F401


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run pl.pallas_call in interpret mode; the JAX package is unchanged."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _spd(n, b=2, seed=0):
    """z z^T + 0.5 I with z [B, N, N/2], as tests/test_pallas_mll.py:88-90."""
    rng = np.random.RandomState(seed)
    z = rng.randn(b, n, max(n // 2, 1)).astype(np.float32)
    return (z @ np.transpose(z, (0, 2, 1))
            + 0.5 * np.eye(n, dtype=np.float32)).astype(np.float32)


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-8))


@pytest.mark.parametrize("n", [256, 384])
def test_factor_matches_pallas_kernel(interpret_pallas, n):
    k = _spd(n)
    want = np.asarray(jbc.blocked_cholesky(jnp.asarray(k)))
    got = tbc.blocked_cholesky(torch.from_numpy(k)).numpy()
    assert got.shape == want.shape == (2, n, n)
    assert _rel(got, want) < 1e-5
    rec = got @ np.transpose(got, (0, 2, 1))
    assert _rel(rec, k) < 1e-5
    assert np.abs(np.triu(got, 1)).max() == 0.0  # exactly lower triangular


@pytest.mark.parametrize("n", [256, 384])
def test_logdet_grad_matches_pallas_vjp(interpret_pallas, n):
    k = _spd(n, seed=1)

    def jloss(kk):
        return jnp.sum(jnp.log(jnp.diagonal(jbc.blocked_cholesky(kk),
                                            axis1=-2, axis2=-1)))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(k)))
    tk = torch.from_numpy(k).requires_grad_(True)
    torch.log(torch.diagonal(tbc.blocked_cholesky(tk), dim1=-2,
                             dim2=-1)).sum().backward()
    assert _rel(tk.grad.numpy(), want) < 2e-2


def test_fallback_shape_is_the_stock_cholesky():
    k = _spd(50)
    before = tbc.blocked_cholesky.launches
    got = tbc.blocked_cholesky(torch.from_numpy(k)).numpy()
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(k)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert tbc.blocked_cholesky.launches == before


@pytest.mark.parametrize("n", [50, 128, 640])
def test_uses_kernel_follows_the_jax_shape_rule(n):
    jax_kernel = n % jbc.T == 0 and n <= jbc.MAX_N
    assert tbc.uses_kernel(n) == jax_kernel


def test_plain_matches_stock_cholesky_at_one_tile():
    k = _spd(128, b=3, seed=2)
    got = tbc.blocked_cholesky_plain(torch.from_numpy(k)).numpy()
    assert _rel(got, np.linalg.cholesky(k.astype(np.float64))) < 1e-5


def test_chol_rev_matches_jax_bwd():
    rng = np.random.RandomState(3)
    k = _spd(40, seed=3)
    chol = np.linalg.cholesky(k.astype(np.float64)).astype(np.float32)
    lbar = np.tril(rng.randn(2, 40, 40)).astype(np.float32)
    want = np.asarray(jbc._bwd(jnp.asarray(chol), jnp.asarray(lbar))[0])
    got = tbc.chol_rev(torch.from_numpy(chol), torch.from_numpy(lbar)).numpy()
    assert _rel(got, want) < 1e-5


def test_cpu_tensors_never_launch_the_kernel():
    before = tbc.blocked_cholesky.launches
    tbc.blocked_cholesky(torch.from_numpy(_spd(256)))
    assert tbc.blocked_cholesky.launches == before


def test_rejects_a_non_square_input():
    with pytest.raises(ValueError):
        tbc.blocked_cholesky(torch.zeros(2, 128, 256))


@pytest.mark.parametrize("n", [256, 384])
def test_tf32x3_algorithm_matches_pallas_kernel(interpret_pallas, n):
    """The kernel's arithmetic, panel through the explicit tile inverse and
    every product in emulated 3xTF32, within the factor tolerance."""
    k = _spd(n, seed=4)
    want = np.asarray(jbc.blocked_cholesky(jnp.asarray(k)))
    got = tbc.blocked_cholesky_plain(torch.from_numpy(k),
                                     product=tf32x3_matmul).numpy()
    assert _rel(got, want) < 1e-5
    assert _rel(got @ np.transpose(got, (0, 2, 1)), k) < 1e-5
    assert np.abs(np.triu(got, 1)).max() == 0.0


def test_tile_inverse_is_the_lower_inverse():
    chol = np.linalg.cholesky(_spd(128, seed=5).astype(np.float64))
    inv = tbc.tile_inverse(torch.from_numpy(chol.astype(np.float32))).numpy()
    assert np.abs(np.triu(inv, 1)).max() == 0.0
    assert _rel(inv, np.linalg.inv(chol)) < 1e-5
