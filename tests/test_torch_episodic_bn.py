"""The episodic BatchNorm op (ops/episodic_batchnorm.py) against the
module's torch route (models/backbones.py::EpisodicBatchNorm, which
ops/episodic_batchnorm.py::batchnorm sends to `batchnorm_torch` on the CPU)
on bf16 inputs, and the route that `batchnorm` chooses.

The op's CPU route is its plain version, which repeats the kernels'
algorithm in torch ops (split partials, the fixed-order finalize, the
scale/shift apply, the closed-form backward); the kernels themselves run
only on the card (chip_smoke.py::check_episodic_batchnorm). The two
sides round differently in f32 before the one bf16 rounding (x scale +
shift against (x - mean) rstd w + b), so outputs agree to a bf16 ulp and
gradients to a relative norm of 1e-2: a flipped ReLU mask at an output
that lies within f32 round-off of 0 moves one element of dx.
"""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from deep_kernel_transfer_tpu_torch.models.backbones import (
    BatchStats, ConvBlock, EpisodicBatchNorm)
from deep_kernel_transfer_tpu_torch.ops import episodic_batchnorm as ebn
from torch_test_threads import one_thread  # noqa: F401


def _inputs(c: int, groups: int, channels_last: bool, seed: int = 0,
            hw: tuple[int, int] = (5, 6)):
    """bf16 x [groups * 3, c, *hw] with a per-channel offset and scale, a
    BatchNorm with drawn weight, bias and running statistics, and a
    bf16 upstream gradient."""
    g = torch.Generator().manual_seed(seed + c + groups)
    n = groups * 3
    x = (torch.randn(n, c, *hw, generator=g) * (0.5 + torch.rand(
        1, c, 1, 1, generator=g)) + torch.randn(1, c, 1, 1, generator=g))
    x = x.to(torch.bfloat16)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    bn = EpisodicBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=g))
        bn.bias.copy_(0.2 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(1.0 + 0.1 * torch.rand(c, generator=g))
    dy = torch.randn(x.shape, generator=g).to(torch.bfloat16)
    return x, bn, dy


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _torch_route(bn, x, groups, relu, dy):
    """The module's torch route: output, x/weight/bias gradients, the new
    running statistics."""
    x = x.detach().requires_grad_(True)
    stats = BatchStats()
    before = ebn.episodic_batchnorm.torch_route
    y = bn(x, True, groups, stats, relu=relu)
    assert ebn.episodic_batchnorm.torch_route == before + 1
    dx, dw, db = torch.autograd.grad(y, (x, bn.weight, bn.bias), dy)
    return y.detach(), dx, dw, db, stats[bn]


def _op(bn, x, groups, relu, dy):
    """The op's CPU route (the plain version): output, gradients, the new
    running statistics."""
    x = x.detach().requires_grad_(True)
    y, new_mean, new_var = ebn.episodic_batchnorm(
        x, bn.weight, bn.bias, bn.running_mean, bn.running_var, groups,
        bn.eps, bn.momentum, relu)
    dx, dw, db = torch.autograd.grad(y, (x, bn.weight, bn.bias), dy)
    return y.detach(), dx, dw, db, (new_mean, new_var)


@pytest.mark.parametrize("c", [64, 512, 1024, 2048])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_op_matches_the_torch_route(c, channels_last, groups, relu):
    _matches_the_torch_route(c, channels_last, groups, relu, (5, 6))


@pytest.mark.parametrize("c", [1024, 2048])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_op_matches_the_torch_route_on_a_7x7_map(c, relu):
    """ResNet50's last stages: C = 1024 and 2048 (2 and 1 tile rows) on
    the 7x7 map of 224-px images."""
    _matches_the_torch_route(c, True, 2, relu, (7, 7))


def _matches_the_torch_route(c, channels_last, groups, relu, hw):
    x, bn, dy = _inputs(c, groups, channels_last, hw=hw)
    want = _torch_route(bn, x, groups, relu, dy)
    got = _op(bn, x, groups, relu, dy)
    y_w, dx_w, dw_w, db_w, (rm_w, rv_w) = want
    y, dx, dw, db, (rm, rv) = got
    assert y.dtype == dx.dtype == torch.bfloat16
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y.float(), y_w.float(), rtol=2 ** -7,
                               atol=1e-5)
    if relu:
        assert bool((y >= 0).all())
    assert _rel(dx, dx_w) < 1e-2
    assert _rel(dw, dw_w) < 1e-2 and _rel(db, db_w) < 1e-2
    torch.testing.assert_close(rm, rm_w, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rv, rv_w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("relu", [False, True])
def test_double_backward_follows_the_torch_route(relu):
    """create_graph: the op's backward runs the differentiable form, whose
    second derivatives match autograd's through the torch route."""
    x, bn, dy = _inputs(64, 2, True, seed=7)
    probe = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))

    def second(fn):
        xr = x.detach().float().requires_grad_(True)
        y = fn(xr.to(torch.bfloat16))
        (gx,) = torch.autograd.grad(y, xr, dy, create_graph=True)
        return torch.autograd.grad((gx.float() * probe).sum(),
                                   (xr, bn.weight))

    want = second(lambda v: bn(v, True, 2, None, relu=relu))
    got = second(lambda v: ebn.episodic_batchnorm(
        v, bn.weight, bn.bias, bn.running_mean, bn.running_var, 2, bn.eps,
        bn.momentum, relu)[0])
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert _rel(a, b) < 2e-2


def test_split_sums_follow_the_plan():
    """The plain sums take the kernels' splits: every split but the last
    full, rows a split a multiple of the CTA's rows at once."""
    for groups, rows, c in [(32, 740880, 64), (16, 5145, 512), (1, 7, 8),
                            (4, 30, 2048), (8, 329280, 256), (8, 20580, 1024),
                            (8, 5145, 2048)]:
        splits, per_split = ebn.plan(groups, rows, c)
        assert 1 <= splits <= ebn.MAX_SPLITS
        assert per_split % (ebn.THREADS // (c // ebn.VEC)) == 0
        assert (splits - 1) * per_split < rows <= splits * per_split
    v = torch.randn(3, 70001, 8, dtype=torch.float64)
    torch.testing.assert_close(ebn._split_sums(v), v.sum(1))


def test_routes_and_counters_on_the_cpu():
    """A CPU tensor never takes the kernels: a bf16 4-D training call is
    counted as the torch route; float32, eval mode and 2-D inputs are not
    counted. The op refuses what the kernels do not take."""
    bn = EpisodicBatchNorm(16)
    x = torch.randn(4, 16, 3, 3)
    before = (ebn.episodic_batchnorm.torch_route,
              ebn.episodic_batchnorm.launches)
    bn(x, True, 2)
    bn(x.to(torch.bfloat16), False, 1)
    bn(torch.randn(4, 16).to(torch.bfloat16), True, 2)
    assert ebn.episodic_batchnorm.torch_route == before[0]
    bn(x.to(torch.bfloat16), True, 2, relu=True)
    assert ebn.episodic_batchnorm.torch_route == before[0] + 1
    assert ebn.episodic_batchnorm.launches == before[1]
    assert ebn.supports(x.to(torch.bfloat16))
    running = (bn.running_mean, bn.running_var)
    for bad in (x, torch.randn(4, 12, 3, 3).to(torch.bfloat16),
                torch.randn(4, 16).to(torch.bfloat16)):
        assert not ebn.supports(bad)
        with pytest.raises(ValueError):
            ebn.episodic_batchnorm(bad, bn.weight, bn.bias, *running, 2)
    with pytest.raises(ValueError):
        ebn.episodic_batchnorm(x.to(torch.bfloat16), bn.weight, bn.bias,
                               *running, 3)


ROUTE_CASES = {  # name: (dtype, 2-D, train, split batch, counted)
    "bf16_episodes": (torch.bfloat16, False, True, False, True),
    "bf16_split": (torch.bfloat16, False, True, True, True),
    "bf16_eval": (torch.bfloat16, False, False, False, False),
    "bf16_2d": (torch.bfloat16, True, True, False, False),
    "f32": (torch.float32, False, True, False, False),
    "f64": (torch.float64, False, True, False, False),
    "f64_split": (torch.float64, False, True, True, False)}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_batchnorm_takes_the_torch_ops_on_the_cpu(case):
    """ops.batchnorm, which chooses the route of every EpisodicBatchNorm,
    takes `batchnorm_torch` for a CPU tensor: in training mode per episode
    and for the split batch (`batch_sum`, here two ranks holding the same
    rows), in eval mode, for f32, f64 and 2-D inputs. The module, the
    route and `batchnorm_torch` give the same output, gradients and
    running statistics bit for bit; only a training input that `supports`
    takes is counted as the torch route, and no kernel is launched."""
    dtype, flat, train, split, counted = ROUTE_CASES[case]
    x, bn, dy = _inputs(16, 1 if split else 2, False)
    x, dy = x.to(dtype), dy.to(dtype)
    if flat:
        x, dy = x[:, :, 0, 0], dy[:, :, 0, 0]
    groups = 1 if split or not train else 2
    batch_sum = (lambda t: t + t) if split else None
    names = ("launches", "torch_route", "copies", "eval_launches",
             "eval_torch_route", "eval_pool_launches")

    def counters():
        return [getattr(ebn.episodic_batchnorm, k) for k in names]

    def run(fn):
        xr = x.detach().requires_grad_(True)
        y, new = fn(xr)
        grads = torch.autograd.grad(y, (xr, bn.weight, bn.bias), dy)
        return (y,) + grads + tuple(new or ())

    def module(xr):
        stats = BatchStats(batch_sum) if train else None
        y = bn(xr, train, groups, stats, relu=True)
        return y, stats and stats[bn]

    args = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    kw = dict(train=train, groups=groups, batch_sum=batch_sum, eps=bn.eps,
              momentum=bn.momentum, relu=True)
    before = counters()
    got = [run(module), run(lambda xr: ebn.batchnorm(xr, *args, **kw))]
    assert [b - a for a, b in zip(before, counters())] == [
        0, 2 * counted, 0, 0, 0, 0]
    want = run(lambda xr: ebn.batchnorm_torch(xr, *args, **kw))
    assert len(want) == (6 if train else 4)
    for route in got:
        assert all(torch.equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(route, want, strict=True))
    assert ebn.supports(x) == (dtype == torch.bfloat16 and not flat)


@pytest.mark.parametrize("c", [64, 2048])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("relu", [False, True])
def test_eval_plain_matches_the_torch_route(c, channels_last, relu):
    """The eval kernel's arithmetic in torch ops (`_eval_plain`, the eval
    op's CPU route): one f32 bf16(x scale + shift) against the module's
    eval chain bf16((x - mean) rstd w + b), within a bf16 ulp, and equal
    at nearly every element."""
    x, bn, _ = _inputs(c, 2, channels_last)
    running = (bn.running_mean, bn.running_var)
    with torch.no_grad():
        want = bn(x, False, 1, relu=relu)
        got = ebn.episodic_batchnorm_eval(x, bn.weight, bn.bias, *running,
                                          bn.eps, relu)
    assert torch.equal(got, ebn._eval_plain(x, bn.weight, bn.bias, *running,
                                            bn.eps, relu))
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5)
    assert float((got != want).float().mean()) < 1e-2
    if relu:
        assert bool((got >= 0).all())


@pytest.mark.parametrize("grad", [False, True])
def test_eval_on_the_cpu_takes_the_torch_route(grad):
    """A CPU eval call, with grad mode on or off, takes the module's torch
    ops and moves no counter; the eval op refuses an input whose output
    would record a gradient."""
    x, bn, _ = _inputs(16, 1, True)
    names = ("launches", "torch_route", "copies", "eval_launches",
             "eval_torch_route", "eval_pool_launches")

    def counters():
        return [getattr(ebn.episodic_batchnorm, k) for k in names]

    before = counters()
    with torch.set_grad_enabled(grad):
        y = bn(x, False, 1, relu=True)
        assert ebn.records_grad(x, bn.weight, bn.bias) == grad
        if grad:
            with pytest.raises(ValueError):
                ebn.episodic_batchnorm_eval(x, bn.weight, bn.bias,
                                            bn.running_mean, bn.running_var)
    assert y.requires_grad == grad
    assert counters() == before


EVAL_PLAN_CASES = [(3200 * 84 * 84, 64), (3200 * 10 * 10, 64),
                   (800 * 56 * 56, 256), (800 * 7 * 7, 2048), (7, 8),
                   (3200 * 112 * 112, 64)]
# Conv4's eval batch pooled: 84 -> 42, 42 -> 21, 21 -> 10 and 10 -> 5 px
POOLED_PLAN_CASES = [(3200 * 42 * 42, 64), (3200 * 21 * 21, 64),
                     (3200 * 10 * 10, 64), (3200 * 5 * 5, 64), (7, 8),
                     (800 * 28 * 28, 2048)]


@pytest.mark.parametrize("rows,c", EVAL_PLAN_CASES)
def test_eval_plan_covers_the_rows(rows, c):
    _plan_covers_the_rows(rows, c, 1)


@pytest.mark.parametrize("rows,c", POOLED_PLAN_CASES)
def test_pooled_eval_plan_covers_the_rows(rows, c):
    """The pooled pass's split, whose output rows read four input rows
    each."""
    _plan_covers_the_rows(rows, c, 4)


def _plan_covers_the_rows(rows, c, window):
    """The eval passes' split: every split but the last full, rows a split
    a multiple of the CTA's rows at once, within the launch limit, and
    about EVAL_ELEMENTS input elements a CTA where the grid allows."""
    splits, per_split = ebn.eval_plan(rows, c, window)
    assert 1 <= splits <= ebn.MAX_GRID
    assert per_split % (ebn.THREADS // (c // ebn.VEC)) == 0
    assert (splits - 1) * per_split < rows <= splits * per_split
    if 1 < rows * c * window / ebn.EVAL_ELEMENTS <= ebn.MAX_GRID:
        assert per_split * c * window < 2 * ebn.EVAL_ELEMENTS


U = 2.0 ** -8  # a bf16 rounding's largest relative error


def _pool_inputs(c: int, px: int, seed: int = 0):
    """bf16 x [2, c, px, px] (a conv output without its bias), a conv bias
    [c] and an eval BatchNorm whose weights take both signs."""
    g = torch.Generator().manual_seed(1000 * seed + c + px)
    x = (torch.randn(2, c, px, px, generator=g) * 1.5 + 0.3).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bn = EpisodicBatchNorm(c)
    with torch.no_grad():
        sign = torch.where(torch.arange(c) % 3 == 1, -1.0, 1.0)
        bn.weight.copy_(sign * (1.0 + 0.3 * torch.rand(c, generator=g)))
        bn.bias.copy_(0.2 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.3 + 0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(2.25 * (1.0 + 0.1 * torch.rand(c, generator=g)))
    conv_bias = 0.4 * torch.randn(c, generator=g)
    return x, bn, conv_bias


def _eval_args(bn):
    return (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)


def _within_roundings(pre, scale, want, got, pool):
    """|got - want| <= one bf16 rounding of each pre-BN magnitude summed in
    `pre`, carried through |scale|, and of each output (max-pooled where
    `pool`, since the max moves no value by more than its window's largest
    move)."""
    move = scale.abs().view(1, -1, 1, 1) * U * pre.abs()
    if pool:
        move = F.max_pool2d(move, 2, 2)
    bound = move + U * (want.float().abs() + got.float().abs()) + 1e-5
    return bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("px", [84, 42, 21, 10, 82, 39])
@pytest.mark.parametrize("c", [8, 64, 128])
@pytest.mark.parametrize("zero_bias", [True, False])
def test_eval_epilogue_plain_against_the_chain(px, c, zero_bias, pool):
    """The eval epilogue's plain versions (`_eval_pool_plain` and
    `_eval_plain` with a conv bias: the CPU route of
    `episodic_batchnorm_eval(..., conv_bias, pool)`, the kernel's
    arithmetic) against the chain they replace, the bf16 bias add, the
    eval BatchNorm+ReLU and max_pool2d where the block pools, on Conv4's
    maps (84, 42, 21, 10 px) and Conv4NP's (82, 39), odd sizes floored, BN
    weights of both signs: bit-equal, with a zero conv bias and a nonzero
    one."""
    x, bn, b = _pool_inputs(c, px)
    if zero_bias:
        b = torch.zeros(c)
    with torch.no_grad():
        got = ebn.episodic_batchnorm_eval(x, *_eval_args(bn), relu=True,
                                          conv_bias=b, pool=pool)
        want = ebn._eval_plain(x + b.to(torch.bfloat16).view(1, c, 1, 1),
                               *_eval_args(bn), True)
        if pool:
            want = F.max_pool2d(want, 2, 2)
    side = px // 2 if pool else px
    assert got.shape == (2, c, side, side) == want.shape
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert bool((got >= 0).all())
    assert torch.equal(got, want)
    if zero_bias:
        with torch.no_grad():
            assert torch.equal(got, ebn.episodic_batchnorm_eval(
                x, *_eval_args(bn), relu=True, pool=pool))


def _block(c_in: int, pool: bool, padding: int, seed: int = 0):
    """A ConvBlock to 64 channels with a nonzero conv bias and eval
    statistics, BN weights of both signs, and a bf16 input [4, c_in, 23,
    23] in channels-last memory."""
    g = torch.Generator().manual_seed(seed)
    block = ConvBlock(c_in, 64, pool=pool, padding=padding)
    _, bn, conv_bias = _pool_inputs(64, 4, seed)
    block.BN.load_state_dict(bn.state_dict())
    with torch.no_grad():
        block.C.bias.copy_(conv_bias)
    x = torch.randn(4, c_in, 23, 23, generator=g).to(torch.bfloat16)
    return block, x.contiguous(memory_format=torch.channels_last)


def _today(block, x, train, groups=1, stats=None):
    """Today's chain of a ConvBlock: conv with bias, `batchnorm`, then
    max_pool2d where the block pools."""
    y = block.BN(block.C(x), train, groups, stats, relu=True)
    return F.max_pool2d(y, 2, 2) if block.pool else y


@pytest.mark.parametrize("pool,padding", [(True, 1), (True, 0), (False, 1)])
def test_eval_conv_block_on_the_fused_route(monkeypatch, pool, padding):
    """An eval ConvBlock on the fused route (the route test made true on
    the CPU, where it needs a CUDA tensor: the conv without its bias, then
    `episodic_batchnorm_eval` adding it, pooled or not)
    against today's chain (conv with bias, the eval torch route, the
    max-pool): the same shape and layout, within a bf16 rounding of each
    pre-BN value that one side rounds (the fused route rounds the conv
    output without its bias, then that plus the bias; today's CPU chain the
    conv output with its bias, added inside the convolution) and of each
    output."""
    block, x = _block(3, pool, padding)
    with torch.no_grad():
        want = _today(block, x, False)
        assert torch.equal(block(x, False), want)  # the CPU keeps the chain
        monkeypatch.setattr(ebn, "takes_eval_epilogue", lambda *a: True)
        got = block(x, False)
        bare = block.C(x, with_bias=False).float()
        exact = bare + block.C.bias.to(torch.bfloat16).float().view(
            1, -1, 1, 1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    scale, _ = ebn._eval_coeffs(*_eval_args(block.BN))
    assert _within_roundings(bare.abs() + 2 * exact.abs(), scale, want,
                             got, pool)


@pytest.mark.parametrize("pool", [True, False])
def test_training_conv_block_keeps_the_chain(monkeypatch, pool):
    """A training-mode ConvBlock, with every condition of the fused route
    but the mode met, gives today's chain bit for bit: output, the new
    running statistics and the gradients."""
    block, x = _block(8, pool, 1, seed=3)
    monkeypatch.setattr(ebn, "takes_eval_epilogue",
                        lambda x, channels, train, *p: not train)
    dy = torch.randn(_today(block, x, True, 2).shape,
                     generator=torch.Generator().manual_seed(5))

    def run(fn):
        stats = BatchStats()
        y = fn(block, x, True, 2, stats)
        params = (block.C.weight, block.C.bias, block.BN.weight,
                  block.BN.bias)
        return (y,) + torch.autograd.grad(y, params, dy.to(y.dtype)) + tuple(
            stats[block.BN])

    got = run(lambda b, *a: b(*a))
    want = run(_today)
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


class _OnTheCard:
    """What `takes_eval_epilogue` reads of a tensor, with is_cuda true: the CPU
    has no CUDA tensor to hand it."""

    is_cuda = True

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


FOLD_CASES = {  # name: (dtype, channels, train, grad mode, x grad, taken)
    "eval": (torch.bfloat16, 64, False, False, False, True),
    "eval_grad_mode": (torch.bfloat16, 64, False, True, False, False),
    "eval_x_grad": (torch.bfloat16, 64, False, True, True, False),
    "eval_x_grad_no_grad_mode": (torch.bfloat16, 64, False, False, True,
                                 True),
    "train": (torch.bfloat16, 64, True, False, False, False),
    "f32": (torch.float32, 64, False, False, False, False),
    "c12": (torch.bfloat16, 12, False, False, False, False),
    "c4096": (torch.bfloat16, 4096, False, False, False, False)}


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_the_fused_route_is_chosen_from_the_input(case):
    """`takes_eval_epilogue` takes an eval, bf16, 4-D CUDA input whose conv
    output `supports` takes and on which no gradient is recorded, and
    nothing else; a CPU tensor never. The eval op refuses a conv bias
    that would record a gradient."""
    dtype, channels, train, grad_mode, x_grad, taken = FOLD_CASES[case]
    x = torch.randn(2, 3, 5, 5, dtype=dtype).requires_grad_(x_grad)
    block = ConvBlock(3, channels)  # its parameters require gradients
    params = (block.C.weight, block.C.bias, block.BN.weight, block.BN.bias)
    with torch.set_grad_enabled(grad_mode):
        assert ebn.takes_eval_epilogue(_OnTheCard(x), channels, train,
                                       *params) == taken
        assert not ebn.takes_eval_epilogue(x, channels, train, *params)
        if grad_mode:
            y, bn, _ = _pool_inputs(8, 4)
            with pytest.raises(ValueError):
                ebn.episodic_batchnorm_eval(
                    y, *_eval_args(bn), relu=True, pool=True,
                    conv_bias=torch.zeros(8, requires_grad=True))


@pytest.mark.parametrize("config,traffic,per_image", [
    ("dkt_conv4_miniimagenet", "train_5w5s16q_b32", 599104),
    ("dkt_resnet10_cub", "train_5w5s16q_b16", 1731072)])
def test_batchnorm_roofline_reader(config, traffic, per_image):
    """dkt_bench's batchnorm_roofline.train: images x BatchNorm elements an
    image x 10 bytes at 3.35 TB/s over the episodic_bn_ kernels' device
    time a step; None where no such kernel ran (the port before them)."""
    from dkt_bench.registry import Registry
    from dkt_bench.trace import Record

    reg = Registry()
    cfg, tr = reg.config(config), reg.traffic(traffic)
    read = reg.reader("batchnorm_roofline.train")
    kernels = [("void (anonymous namespace)::episodic_bn_stats(...)", 4e-3,
                ()), ("void (anonymous namespace)::episodic_bn_grad_apply"
                      "<true>(...)", 6e-3, ()), ("gram_kernel", 1.0, ())]
    r = Record("train", cfg, tr, 2, 1.0, 0.9, kernels)
    images = tr["episode_batch"] * 105
    assert read(r) == pytest.approx(100 * images * per_image * 10 / 3.35e12
                                    * 2 / 10e-3)
    assert read(Record("train", cfg, tr, 2, 1.0, 0.9, kernels[2:])) is None
    assert read(Record("eval", cfg, tr, 2, 1.0, 0.9, kernels)) is None
