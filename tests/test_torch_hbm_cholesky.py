"""The port's left-looking and fused-Gram Cholesky (deep_kernel_transfer_
tpu_torch/ops/hbm_cholesky.py) and its memory demo against the JAX
package's Pallas kernel, run in interpret mode on the CPU, on the same
numpy inputs.

On CPU tensors the port's wrappers take their plain torch versions (the
kernel's left-looking algorithm in torch ops) with the JAX package's
backwards; the CUDA kernel itself is held to those plain versions on the
card by chip_smoke.py. Tolerances are those of the JAX package's own tests
(tests/test_pallas_mll.py:148,153,161,234): factors 1e-5 relative to the
largest entry, gradients 2e-2 relative.
"""
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from deep_kernel_transfer_tpu.ops.pallas import hbm_cholesky as jhc
from deep_kernel_transfer_tpu_torch.benchmarks import hbm_memory_demo as demo
from deep_kernel_transfer_tpu_torch.ops import hbm_cholesky as thc
from deep_kernel_transfer_tpu_torch.ops.tf32x3 import (tf32_round, tf32_split,
                                                       tf32x3_matmul)
from torch_test_threads import one_thread  # noqa: F401

B, N, D = 2, 384, 128  # the shape of tests/test_pallas_mll.py:141


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run pl.pallas_call in interpret mode; the JAX package is unchanged."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _z(b=B, n=N, d=D, seed=0):
    return (np.random.RandomState(seed).randn(b, n, d) * 0.3).astype(
        np.float32)


def _gram(z):
    return np.einsum("bnd,bmd->bnm", z.astype(np.float64),
                     z.astype(np.float64)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-8))


def _lower_tiles(lt):
    """The tiles on and below the diagonal of [B, nt, nt, T, T]."""
    nt = lt.shape[1]
    return np.stack([lt[:, i, j] for i in range(nt) for j in range(i + 1)], 1)


def test_general_matches_pallas_kernel(interpret_pallas):
    k = _gram(_z())
    want = np.asarray(jhc.hbm_blocked_cholesky(jnp.asarray(k), 1.0))
    got = thc.hbm_blocked_cholesky(torch.from_numpy(k), 1.0).numpy()
    assert got.shape == want.shape == (B, N, N)
    assert _rel(got, want) < 1e-5
    assert np.abs(np.triu(got, 1)).max() == 0.0


def test_fused_matches_pallas_kernel(interpret_pallas):
    z = _z()
    want = np.asarray(jhc.fused_gram_cholesky(jnp.asarray(z), 1.0, 1.0))
    got = thc.fused_gram_cholesky(torch.from_numpy(z), 1.0, 1.0).numpy()
    assert got.shape == want.shape == (B, N, N)
    assert _rel(got, want) < 1e-5


def test_tiled_and_log_det_match_pallas_kernel(interpret_pallas):
    z = _z(seed=1)
    jlt = jhc.fused_gram_cholesky_tiled(jnp.asarray(z), 1.0, 1.0)
    tlt = thc.fused_gram_cholesky_tiled(torch.from_numpy(z), 1.0, 1.0)
    assert tuple(tlt.shape) == jlt.shape == (B, 3, 3, 128, 128)
    assert _rel(_lower_tiles(tlt.numpy()), _lower_tiles(np.asarray(jlt))) < 1e-5
    want = np.asarray(jhc.tiled_log_det(jlt))
    got = thc.tiled_log_det(tlt).numpy()
    assert got.shape == (B,)
    assert _rel(got, want) < 1e-5


def test_general_grads_match_pallas_vjp(interpret_pallas):
    k = _gram(_z(seed=2))

    def jloss(kk, dd):
        lo = jhc.hbm_blocked_cholesky(kk, dd)
        return jnp.sum(jnp.log(jnp.diagonal(lo, axis1=-2, axis2=-1)))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(k), jnp.float32(1.0))
    tk = torch.from_numpy(k).requires_grad_(True)
    td = torch.tensor(1.0, requires_grad=True)
    torch.log(torch.diagonal(thc.hbm_blocked_cholesky(tk, td), dim1=-2,
                             dim2=-1)).sum().backward()
    assert _rel(tk.grad.numpy(), want[0]) < 2e-2
    assert _rel(td.grad.numpy(), want[1]) < 2e-2


def test_fused_grads_match_pallas_vjp(interpret_pallas):
    z = _z(seed=3)
    y = np.random.RandomState(4).randn(B, N).astype(np.float32)

    def jloss(zz, s, d):
        lo = jhc.fused_gram_cholesky(zz, s, d)
        al = jax.scipy.linalg.cho_solve((lo, True), jnp.asarray(y)[..., None])
        return (jnp.sum(jnp.log(jnp.diagonal(lo, axis1=-2, axis2=-1)))
                + 0.5 * jnp.sum(jnp.asarray(y)[..., None] * al))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(z), jnp.float32(0.7), jnp.float32(1.3))
    args = [torch.from_numpy(z).requires_grad_(True),
            torch.tensor(0.7, requires_grad=True),
            torch.tensor(1.3, requires_grad=True)]
    lo = thc.fused_gram_cholesky(*args)
    al = torch.cholesky_solve(torch.from_numpy(y)[..., None], lo)
    loss = (torch.log(torch.diagonal(lo, dim1=-2, dim2=-1)).sum()
            + 0.5 * (torch.from_numpy(y)[..., None] * al).sum())
    got = torch.autograd.grad(loss, args)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 2e-2


def test_tile_matrix_round_trip_matches_jax():
    k = np.random.RandomState(5).randn(2, 256, 256).astype(np.float32)
    tiled = thc.tile_matrix(torch.from_numpy(k))
    assert np.array_equal(tiled.numpy(), np.asarray(jhc._tile_matrix(k)))
    assert np.array_equal(thc.untile_matrix(tiled).numpy(), k)


@pytest.mark.parametrize("entry", ["hbm_blocked_cholesky",
                                   "fused_gram_cholesky",
                                   "fused_gram_cholesky_tiled"])
def test_rejects_shapes_off_the_tile(entry):
    fn = getattr(thc, entry)
    bad_n = torch.zeros(1, 200, 200 if entry == "hbm_blocked_cholesky"
                        else 128)
    with pytest.raises(ValueError, match="multiple of 128"):
        fn(bad_n, 1.0) if entry == "hbm_blocked_cholesky" else fn(bad_n, 1.0,
                                                                   1.0)
    if entry != "hbm_blocked_cholesky":
        with pytest.raises(ValueError, match="D=96"):
            fn(torch.zeros(1, 128, 96), 1.0, 1.0)


def test_tiled_is_forward_only():
    z = torch.from_numpy(_z(b=1, n=128)).requires_grad_(True)
    with pytest.raises(ValueError, match="forward only"):
        thc.fused_gram_cholesky_tiled(z, 1.0, 1.0)
    with pytest.raises(ValueError, match="forward only"):
        thc.fused_gram_cholesky_tiled(z.detach(), torch.tensor(
            1.0, requires_grad=True), 1.0)


def test_cpu_tensors_never_launch_the_kernel():
    z = torch.from_numpy(_z(b=1, n=256))
    counters = (thc.hbm_blocked_cholesky, thc.fused_gram_cholesky,
                thc.fused_gram_cholesky_tiled)
    before = [f.launches for f in counters]
    thc.hbm_blocked_cholesky(z @ z.mT, 1.0)
    thc.fused_gram_cholesky(z, 1.0, 1.0)
    thc.fused_gram_cholesky_tiled(z, 1.0, 1.0)
    assert [f.launches for f in counters] == before


def _jax_demo_logdet(z):
    """The JAX demo's xla arm (benchmarks/hbm_memory_demo.py:41-47)."""
    k = 2.0 * jnp.einsum("bnd,bmd->bnm", z, z,
                         precision=jax.lax.Precision.HIGHEST)
    k = k + 0.1 * jnp.eye(z.shape[1], dtype=k.dtype)
    lo = jnp.linalg.cholesky(k)
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(lo, axis1=-2, axis2=-1)), -1)


def test_demo_arms_agree_with_each_other_and_the_jax_demo():
    z = demo.make_z(256, 128, seed=0, device="cpu")
    assert torch.allclose(z.norm(dim=-1), torch.ones(1, 256))
    plain = float(demo.logdet_plain(z.clone())[0])
    fused = float(demo.logdet_fused(z)[0])
    want = float(_jax_demo_logdet(jnp.asarray(z.numpy()))[0])
    assert abs(plain - fused) / abs(plain) < 1e-5
    assert abs(plain - want) / abs(want) < 1e-5


def test_demo_runs_each_arm_in_a_subprocess(capsys):
    assert demo.main(["--sizes", "256", "--feat_dim", "128", "--device",
                      "cpu", "--timeout", "300"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    rows = [json.loads(l) for l in lines]
    assert [r["arm"] for r in rows[:2]] == ["plain", "fused"]
    assert all(r["ok"] and np.isfinite(r["logdet"]) for r in rows[:2])
    assert rows[-1]["ok"] and rows[-1]["parity"]["n"] == 256


def test_tf32_split_rounds_to_ten_mantissa_bits():
    rng = np.random.RandomState(6)
    a = (rng.randn(4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(
        np.float32)
    a[:4] = [1.0, -1.0, 1.0 + 2.0 ** -11, 3.0]  # exact and tie cases
    hi, lo = tf32_split(torch.from_numpy(a))
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rebuilt = (hi.double() + lo.double()).numpy()
    assert np.all(np.abs(rebuilt - a) <= 2.0 ** -21 * np.abs(a))
    # ties round away from zero, as cvt.rna does
    assert float(hi[2]) == 1.0 + 2.0 ** -10


def test_tf32x3_matmul_keeps_f32_accuracy():
    rng = np.random.RandomState(7)
    a = rng.randn(3, 128, 384).astype(np.float32)
    b = rng.randn(384, 128).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    got = tf32x3_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    one_pass = (tf32_round(torch.from_numpy(a))
                @ tf32_round(torch.from_numpy(b))).numpy()
    assert _rel(got, exact) < 2e-6
    assert _rel(one_pass, exact) > 1e-4  # single-pass TF32 would not do


@pytest.mark.parametrize("fused", [False, True])
def test_tf32x3_algorithm_matches_pallas_kernel(interpret_pallas, fused):
    """The kernel's arithmetic (panel through the explicit tile inverse,
    every Gram, strip and panel product in emulated 3xTF32) against the
    Pallas kernel, general and fused, within the factor tolerance."""
    z = _z(seed=8)
    if fused:
        jlt = jhc.fused_gram_cholesky_tiled(jnp.asarray(z), 1.0, 1.0)
        src = torch.from_numpy(z)
    else:
        k = _gram(z)
        jlt = jhc._tile_matrix(jhc.hbm_blocked_cholesky(jnp.asarray(k), 1.0))
        src = torch.from_numpy(k)
    got = thc._tiled_plain(src, fused, 1.0, 1.0, product=tf32x3_matmul)
    assert _rel(_lower_tiles(got.numpy()), _lower_tiles(np.asarray(jlt))) < 1e-5
    assert _rel(thc.tiled_log_det(got).numpy(), jhc.tiled_log_det(jlt)) < 1e-5
