"""The 3xTF32 product of the tile-Cholesky kernels, emulated in torch ops.

The kernels in `csrc/tile_cholesky.cuh` form every strip, Gram and panel
product on the tensor cores in TF32 (10 explicit mantissa bits), split so
that the result keeps about f32 accuracy: each f32 operand is
a = a_hi + a_lo with a_hi = cvt.rna.tf32.f32(a) and a_lo = tf32(a - a_hi),
and a b = a_hi b_hi + a_hi b_lo + a_lo b_hi, accumulated in f32 (the
a_lo b_lo term, about 2^-22 of the product, is dropped). This module
repeats that arithmetic on any device, so the CPU tests can hold the
kernels' algorithm, with its product, to the JAX package.
"""
from __future__ import annotations

import torch

from ..gp.kernels import full_f32

_LOW_BITS = 0x1FFF  # the 13 low mantissa bits that TF32 drops


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round an f32 tensor to 10 mantissa bits, to the
    nearest with ties away from zero, through its int32 bit pattern (the
    sign bit stays apart, so adding half an ulp to the magnitude rounds
    both signs alike; a carry into the exponent is the right result)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~_LOW_BITS).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi); hi + lo is x to about
    2^-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


@full_f32()
def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (torch.matmul's broadcasting) as the kernels form it:
    a_hi b_hi + a_hi b_lo + a_lo b_hi, each product in f32."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)
