"""Swin-T in the port (models/backbones.py::SwinTransformer, ops/
window_attention.py) against the benchmark's plain reference trunk
(dkt_bench/reference/trunk_SwinT.py), on the CPU.

At a tiny spec (C = 16, blocks (2, 2), heads (1, 2), 2x2 windows, 16 px:
an unshifted block, a shifted one, a patch merging, and a stage whose 2x2
map is one unshifted window), from weights drawn by the benchmark's
trained laws: the features and every trunk leaf's gradient of a fixed
projection of them, in float64 and in the bf16 law. At the published
widths: the parameter layout against the port's state_dict, the features
of two 224-px images in float32, the multiply-adds by hand, the DKT model
the train CLI builds. Also the index and mask helpers against the
reference's, the reader of `window_attention_roofline.train`, and the
spans of a DKT train step.

Tests marked `chip` hold the CUDA kernels to the torch chain on the card
(they skip without one; run them there with `-m chip`). Torch is held to
one thread.
"""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from dkt_bench import flops
from dkt_bench.reference import common, dkt as ref, trunk_SwinT
from deep_kernel_transfer_tpu_torch import factory
from deep_kernel_transfer_tpu_torch.methods.base import apply_trunk
from deep_kernel_transfer_tpu_torch.methods.dkt import DKT
from deep_kernel_transfer_tpu_torch.models.backbones import (SwinTransformer,
                                                             model_dict)
from deep_kernel_transfer_tpu_torch.ops import window_attention as wa
from test_torch_spans import _host_events, _spans, _within
from torch_test_threads import one_thread  # noqa: F401

PX = 16
TINY = {"patch": 4, "dim": 16, "depths": (2, 2), "heads": (1, 2),
        "window": 2, "mlp_ratio": 4}
# Gaps relative to the reference's norm (features), and over the larger of
# a leaf's gradient norm and the median leaf's (gradients). float64: the
# two sides order their arithmetic differently (the port scales q k^T
# after the product, the reference scales q before it), read features 0
# and gradients 1.4e-16 to 2.6e-16 over seeds 1-6. The bf16 law: the
# reference rounds q k^T to bf16 as the published code does, where the
# port's chain keeps the scores in f32, so softmax inputs differ by bf16
# rounding; read features 0 to 3.5e-4 and gradients 5.1e-3 to 8.3e-3 at
# the worst leaf over seeds 1-6.
TOL = {"float64": {"features": 1e-10, "grad": 1e-10},
       "bf16": {"features": 5e-3, "grad": 5e-2}}


def _tiny_port() -> SwinTransformer:
    return SwinTransformer(PX, TINY["patch"], TINY["dim"], TINY["depths"],
                           TINY["heads"], TINY["window"], TINY["mlp_ratio"])


def _draw(seed: int) -> dict:
    """The tiny trunk's leaves by the benchmark's trained laws."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, kind) in trunk_SwinT.param_shapes(PX, TINY).items():
        z = torch.randn(shape, generator=gen)
        u = torch.rand(shape, generator=gen)
        out[name] = (z * (2.0 / (shape[0] * shape[2] * shape[3])) ** 0.5
                     if kind == "conv" else ref.LAWS[kind][True](z, u))
    return out


def _images(seed: int, n: int = 3, px: int = PX) -> torch.Tensor:
    return torch.randint(0, 256, (n, px, px, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _grad_gap(got: dict, want: dict) -> tuple[float, str]:
    norms = sorted(float(g.norm()) for g in want.values())
    median = norms[len(norms) // 2]
    return max((float((got[n].double() - g.double()).norm())
                / max(float(g.norm()), median), n) for n, g in want.items())


@pytest.mark.parametrize("law", ["float64", "bf16"])
@pytest.mark.parametrize("seed", [1, 2])
def test_tiny_port_matches_the_reference(law, seed):
    p = _draw(seed)
    x = _images(seed)
    proj = torch.randn((3, 32), generator=torch.Generator().manual_seed(9),
                       dtype=torch.float64)
    dtype = torch.float64 if law == "float64" else torch.bfloat16
    leaves = {n: (v.double() if law == "float64" else v).requires_grad_(True)
              for n, v in p.items()}
    want = trunk_SwinT.forward(leaves, x, True, 1,
                               "float64" if law == "float64" else "stated",
                               {}, spec=TINY)
    g_want = dict(zip(leaves, torch.autograd.grad(
        (want.double() * proj).sum(), list(leaves.values()))))
    net = _tiny_port()
    net.load_state_dict({k[len("feature."):]: v for k, v in p.items()})
    if law == "float64":
        net = net.double()
    got, _ = apply_trunk(net, x, True, dtype=dtype)
    params = dict(net.named_parameters())
    g_got = dict(zip(("feature." + k for k in params), torch.autograd.grad(
        (got.double() * proj).sum(), list(params.values()))))
    assert got.dtype == (torch.float64 if law == "float64" else torch.float32)
    assert _rel(got, want) < TOL[law]["features"]
    assert set(g_got) == set(g_want)
    gap, leaf = _grad_gap(g_got, g_want)
    assert gap < TOL[law]["grad"], (leaf, gap)


def test_param_shapes_are_the_port_state_dict():
    net = model_dict["SwinT"]()
    port = {"feature." + k: tuple(v.shape) for k, v in net.state_dict().items()}
    mine = trunk_SwinT.param_shapes(224)
    assert list(mine) == list(port)
    assert {k: s for k, (s, _) in mine.items()} == port
    assert sum(v.numel() for v in net.parameters()) == 27519354
    assert not list(net.buffers())  # the attention builds index and mask
    tables = {k for k, (_, kind) in mine.items() if kind == "table"}
    assert len(tables) == 12


def test_published_widths_float32(monkeypatch):
    """Two 224-px images through the port's SwinT and the reference, both
    in true float32: the features agree to float32's round-off carried
    through 12 blocks (read 2.4e-7 to 2.6e-7 over three draws)."""
    def trunk_dtype(name):
        return torch.float32 if name == "float32" else torch.bfloat16
    monkeypatch.setattr(common, "trunk_dtype", trunk_dtype)
    monkeypatch.setattr(trunk_SwinT, "trunk_dtype", trunk_dtype)
    cfg = {"model": "SwinT", "image_size": 224}
    p = ref.draw_weights(cfg, 5, torch.Generator().manual_seed(3), "cpu",
                         trained=True)
    trunk = {k: v for k, v in p.items() if ".bn_out." not in k
             and not k.startswith("gp.")}
    x = _images(4, n=2, px=224)
    with torch.no_grad():
        want = trunk_SwinT.forward(trunk, x, False, 1, "float32", {})
        net = model_dict["SwinT"]()
        net.load_state_dict({k[len("feature."):]: v for k, v in trunk.items()})
        got, _ = apply_trunk(net, x, False, dtype=torch.float32)
    assert got.shape == want.shape == (2, 768)
    assert _rel(got, want) < 1e-5


def test_counts_by_hand():
    """4,489,798,656 multiply-adds an image at 224 px (the paper's 4.5 G),
    1,430,016 attention elements (tokens x channels over the 12 blocks)."""
    patch = 56 * 56 * 96 * 3 * 16
    total, elements, res, c = patch, 0, 56, 96
    for depth in (2, 2, 6, 2):
        t = res * res
        total += depth * (t * c * 3 * c + 2 * t * 49 * c + t * c * c
                          + 8 * t * c * c)
        elements += depth * t * c
        if c < 768:
            total += (t // 4) * 4 * c * 2 * c
            res, c = res // 2, 2 * c
    assert (total, elements) == (4489798656, 1430016)
    assert sum(flops.trunk_macs("SwinT", 224)) == total
    assert flops.trunk_macs("SwinT", 224)[0] == patch
    shapes = trunk_SwinT.attention_shapes(224)
    assert sum(t * ch for t, ch, _, _, _ in shapes) == elements
    assert [s for *_, s in shapes] == [False, True] * 5 + [False, False]
    assert trunk_SwinT.feat_dim(224) == 768


@pytest.mark.parametrize("res,window,shift", [(56, 7, 3), (4, 2, 1),
                                              (7, 7, 0)])
def test_index_and_mask_are_the_references(res, window, shift):
    assert torch.equal(wa.relative_index(window),
                       trunk_SwinT.relative_index(window, "cpu"))
    mask = wa.shift_mask(res, res, window, shift)
    if shift:
        assert torch.equal(mask, trunk_SwinT.attention_mask(res, window,
                                                            shift, "cpu"))
    else:
        assert mask is None


def test_cpu_takes_the_chain_uncounted():
    qkv = torch.randn(2, 16, 3 * 32, dtype=torch.bfloat16)
    table = torch.randn(9, 1)
    before = (wa.window_attention.launches, wa.window_attention.torch_route)
    o = wa.window_attention(qkv, table, 1, 2, 1, (4, 4))
    assert o.shape == (2, 16, 32) and o.dtype == torch.bfloat16
    assert (wa.window_attention.launches,
            wa.window_attention.torch_route) == before
    assert wa.supports(qkv, 1, 2, (4, 4))
    assert not wa.supports(qkv.float(), 1, 2, (4, 4))
    assert not wa.supports(torch.randn(2, 16, 48, dtype=torch.bfloat16), 1,
                           2, (4, 4))  # heads of 16
    assert not wa.supports(qkv, 1, 3, (4, 4))  # windows that do not tile


def test_train_cli_builds_it_at_224_px():
    params = SimpleNamespace(model="SwinT", method="DKT", dataset="CUB",
                             kernel_type="bncossim")
    assert factory.resolve_image_size(params) == 224
    net = factory.build_method(params, 5, 5, device="cpu")
    assert isinstance(net, DKT) and isinstance(net.feature, SwinTransformer)
    assert net.feature.out_dim(224, 224) == 768


def test_window_attention_roofline_reader():
    """The larger of 22 bytes an attention element at 3.35 TB/s and seven
    products at 989 TFLOP/s, over the window_attn_ kernels' device time a
    step; None where none ran, in eval mode, or for a trunk with no
    attention shapes."""
    from dkt_bench.registry import Registry
    from dkt_bench.trace import Record

    reg = Registry()
    read = reg.reader("window_attention_roofline.train")
    cfg, tr = reg.config("dkt_swint_cub"), reg.traffic("train_5w5s16q_b8")
    kernels = [("void (anonymous namespace)::window_attn_fwd(...)", 3e-3, ()),
               ("void (anonymous namespace)::window_attn_bwd(...)", 7e-3, ()),
               ("gram_kernel", 1.0, ())]
    elements, macs = 840 * 1430016, 840 * 1430016 * 49
    bound = max(22 * elements / 3.35e12, 14 * macs / 989e12)
    assert bound == 22 * elements / 3.35e12  # bytes bind
    rec = Record("train", cfg, tr, 2, 1.0, 0.9, kernels)
    assert read(rec) == pytest.approx(100 * bound * 2 / 10e-3)
    assert read(Record("train", cfg, tr, 2, 1.0, 0.9, kernels[2:])) is None
    assert read(Record("eval", cfg, tr, 2, 1.0, 0.9, kernels)) is None
    resnet = reg.config("dkt_resnet50_cub")
    assert read(Record("train", resnet, tr, 2, 1.0, 0.9, kernels)) is None


def test_spans_of_a_train_step():
    """dkt.block once a block, dkt.attention once inside each, dkt.merge
    once a patch merging, all inside dkt.trunk."""
    net = DKT(_tiny_port(), 5, 1, "bncossim", feature_dtype="float32",
              device="cpu").init(torch.zeros((5, 2, PX, PX, 3),
                                             dtype=torch.uint8))
    x = torch.randint(0, 256, (2, 5, 2, PX, PX, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(5))
    spans = _spans(_host_events(lambda: net.train_step(x)))
    assert len(spans["block"]) == len(spans["attention"]) == 4
    assert len(spans["merge"]) == 1
    trunk = spans["trunk"][0]
    for block, attn in zip(sorted(spans["block"]), sorted(spans["attention"])):
        assert _within(attn, block) and _within(block, trunk)
    assert _within(spans["merge"][0], trunk)
    assert not any(_within(m, b) for m in spans["merge"]
                   for b in spans["block"])


# -- on the card --------------------------------------------------------

@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


def _attention_inputs(n, res, heads, window, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((n, res * res, 3 * 32 * heads), generator=gen,
                      device=device).to(torch.bfloat16)
    table = 0.5 * torch.randn(((2 * window - 1) ** 2, heads), generator=gen,
                              device=device)
    do = torch.randn((n, res * res, 32 * heads), generator=gen,
                     device=device).to(torch.bfloat16)
    return qkv, table, do


def _both_routes(qkv, table, do, heads, window, shift, res):
    out = {}
    for route, fn in (("kernel", wa.window_attention),
                      ("chain", wa.window_attention_torch)):
        q = qkv.clone().requires_grad_(True)
        t = table.clone().requires_grad_(True)
        o = fn(q, t, heads, window, shift, (res, res))
        dq, dt = torch.autograd.grad(o, (q, t), do)
        out[route] = (o.float(), dq.float(), dt.float())
    return out


@pytest.mark.chip
@pytest.mark.parametrize("n,res,heads,window,shift", [
    (6, 56, 3, 7, 0), (6, 56, 3, 7, 3), (8, 14, 12, 7, 3), (8, 7, 24, 7, 0),
    (4, 16, 2, 4, 2), (4, 8, 1, 8, 4)])
def test_kernel_matches_the_chain_on_the_card(card, n, res, heads, window,
                                              shift):
    """o, dqkv and the table's gradient of the kernels against the torch
    chain in bf16: o within 2^-7 and dqkv within 2^-6 of the largest
    value (the two round p at the same place, but the chain rounds dp to
    bf16 where the kernel rounds ds, and they sum in other orders), the
    table's f32 sums within 1e-2 of their norm; one forward and one
    backward launch, none to the chain; o bit-equal over two calls."""
    qkv, table, do = _attention_inputs(n, res, heads, window, card)
    before = (wa.window_attention.launches, wa.window_attention.torch_route)
    got = _both_routes(qkv, table, do, heads, window, shift, res)
    torch.cuda.synchronize()
    assert (wa.window_attention.launches - before[0],
            wa.window_attention.torch_route - before[1]) == (2, 0)
    (o, dq, dt), (o_c, dq_c, dt_c) = got["kernel"], got["chain"]
    for a, b, tol in ((o, o_c, 2 ** -7), (dq, dq_c, 2 ** -6)):
        err = float((a - b).abs().max() / b.abs().max())
        assert err < tol, err
    assert _rel(dt, dt_c) < 1e-2
    again = wa.window_attention(qkv, table, heads, window, shift, (res, res))
    assert torch.equal(again.float(), o)


@pytest.mark.chip
def test_second_order_through_the_kernels_is_the_chains(card):
    """A create_graph gradient through the kernels' forward: one forward
    launch, and the backward is the chain's, counted in
    `window_attention.torch_route`; the first- and second-order gradients
    of qkv and the table agree with the chain's own within the kernel
    test's bounds (the chain's backward recomputes o from the same saved
    inputs)."""
    n, res, heads, window, shift = 2, 14, 2, 7, 3
    qkv, table, do = _attention_inputs(n, res, heads, window, card, seed=1)
    gen = torch.Generator(device=card).manual_seed(2)
    r = torch.randn(qkv.shape, generator=gen, device=card)
    out = {}
    for route, fn in (("kernel", wa.window_attention),
                      ("chain", wa.window_attention_torch)):
        q = qkv.clone().requires_grad_(True)
        t = table.clone().requires_grad_(True)
        before = (wa.window_attention.launches,
                  wa.window_attention.torch_route)
        o = fn(q, t, heads, window, shift, (res, res))
        dq, dt = torch.autograd.grad(o, (q, t), do, create_graph=True)
        counted = (wa.window_attention.launches - before[0],
                   wa.window_attention.torch_route - before[1])
        loss = (dq.float() * r).sum() + (dt * dt).sum()
        out[route] = (o.float(), dq.float(), dt.float(), counted) + \
            tuple(g.float() for g in torch.autograd.grad(loss, (q, t)))
    (o, dq, dt, counted, ddq, ddt) = out["kernel"]
    (o_c, dq_c, dt_c, counted_c, ddq_c, ddt_c) = out["chain"]
    assert counted == (1, 1) and counted_c == (0, 0)
    assert float((o - o_c).abs().max() / o_c.abs().max()) < 2 ** -7
    assert float((dq - dq_c).abs().max() / dq_c.abs().max()) < 2 ** -6
    assert _rel(dt, dt_c) < 1e-2
    assert float(ddq_c.abs().max()) > 0 and float(ddt_c.abs().max()) > 0
    assert float((ddq - ddq_c).abs().max() / ddq_c.abs().max()) < 2 ** -6
    assert _rel(ddt, ddt_c) < 1e-2
