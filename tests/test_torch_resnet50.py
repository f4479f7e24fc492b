"""ResNet50 in the port's DKT against the benchmark's plain reference trunk
(dkt_bench/reference/trunk_ResNet50.py), on the CPU.

The port's `ResNet50` at its published widths (64-2048 channels, all 16
bottleneck blocks) on 32-px images, two episodes of 5w1s1q, from weights
drawn by `reference.dkt.draw_weights` in its initial and its trained law:
the bncossim features, the MLL loss, every trainable leaf's gradient (the
trunk's and the GP's) and the BatchNorm running averages, in float32 and
float64. The reference has no float32 law of its own (its trunk computes in
bfloat16 or float64), so the float32 case runs it with `trunk_dtype`
giving float32: the same plain ops in true float32. The port's fused MLL
adds a 1e-6 jitter to the 0.1 noise (a logged divergence), so the
reference is given the noise 0.1 + 1e-6.

Also: the reference's parameter layout against the port's state_dict; the
recomputing forward's gradients against a plain forward's; the trunk's
counts against sums by hand; the reader of
`batchnorm_layers_roofline.train`; and the `dkt.block` and `dkt.residual`
spans of ResNet50 and ResNet10. Torch is held to one thread.
"""
from __future__ import annotations

import pytest
import torch

from dkt_bench import flops
from dkt_bench.reference import common, dkt as ref, trunk_ResNet50
from deep_kernel_transfer_tpu_torch.methods.dkt import DKT
from deep_kernel_transfer_tpu_torch.models.backbones import model_dict
from test_torch_spans import BACKWARD, _host_events, _spans, _within
from torch_test_threads import one_thread  # noqa: F401

B, WAY, SHOT, QUERY, PX = 2, 5, 1, 1, 32
NOISE, JITTER = 0.1, 1e-6
CFG = {"model": "ResNet50", "image_size": PX, "gp_noise": NOISE + JITTER}
TRAFFIC = {"n_way": WAY, "n_support": SHOT, "n_query": QUERY}
DTYPES = {"float32": torch.float32, "float64": torch.float64}
# Relative gaps allowed, by precision, with the largest read (initial and
# trained law). float64: the two sides order BatchNorm's arithmetic
# differently ((x - mean) rsqrt(var + eps) against (x - mean) / sqrt(var +
# eps)), features 1.0e-13 and running averages 1.6e-14; the loss and the
# gradients read more (7.9e-10, 2.0e-9 at the GP's leaves) because the
# reference's noise is the noise times a float32 identity, so its float64
# law carries the noise rounded to float32 (1.5e-8 of it). float32: the
# same orderings at float32's 6e-8, carried through 16 blocks whose last
# BatchNorms see 10 values a channel an episode at 32 px: features 6.6e-5,
# loss 2.0e-7, running averages 1.1e-5; gradients 2.3e-4 of the worst leaf
# on the initial law, 1.2e-2 on the trained one, where a ReLU whose input
# lies within round-off of 0 takes the other branch on one side and its
# element's gradient goes with it. A gradient gap is over the larger of the
# leaf's norm and the median leaf's: a conv bias under a training-mode
# BatchNorm has a gradient of round-off alone (nought in exact arithmetic).
TOL = {"float64": {"features": 1e-12, "loss": 1e-8, "grad": 1e-8,
                   "running": 1e-12},
       "float32": {"features": 3e-4, "loss": 1e-6, "grad": 0.05,
                   "running": 1e-4}}


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _episodes(seed: int) -> torch.Tensor:
    return torch.randint(0, 256, (B, WAY, SHOT + QUERY, PX, PX, 3),
                         generator=_gen(seed), dtype=torch.uint8)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _port(weights: dict, dtype: str) -> DKT:
    net = DKT(model_dict["ResNet50"](), WAY, SHOT, "bncossim", noise=NOISE,
              feature_dtype=dtype, device="cpu")
    net.init(torch.zeros((WAY, SHOT + QUERY, PX, PX, 3), dtype=torch.uint8))
    net.load_state_dict(weights, strict=True)
    return net.to(DTYPES[dtype])


@pytest.fixture(scope="module")
def drawn():
    return {trained: ref.draw_weights(CFG, WAY, _gen(20 + trained), "cpu",
                                      trained=trained)
            for trained in (False, True)}


@pytest.fixture
def law(request, monkeypatch):
    """The reference's law for the precision: float64 as it is, float32
    with its trunk computing in float32."""
    if request.param == "float32":
        def trunk_dtype(name):
            return DTYPES.get(name, torch.bfloat16)
        monkeypatch.setattr(common, "trunk_dtype", trunk_dtype)
        monkeypatch.setattr(trunk_ResNet50, "trunk_dtype", trunk_dtype)
    return request.param


def _no_recompute(monkeypatch):
    """The reference's blocks kept, not recomputed in the backward: the
    same values bit for bit, as the recompute test below shows."""
    monkeypatch.setattr(trunk_ResNet50, "checkpoint",
                        lambda fn, *a, **k: fn(*a))


def _reference(weights: dict, x: torch.Tensor, law: str):
    """(features, loss, {leaf: gradient}, {BatchNorm: (mean, var)})."""
    names = ref.trainable(CFG, WAY)
    p = {n: v.to(DTYPES[law]) for n, v in weights.items()}
    leaves = {n: p[n].clone().requires_grad_(True) for n in names}
    stats: dict = {}
    # reference.dkt.batch_loss, its features kept
    z = ref.features(CFG, {**p, **leaves}, x, True, law, stats)
    loss = -common.gp_mll(leaves, z, WAY, SHOT + QUERY, CFG["gp_noise"],
                          law).sum(1).mean()
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    return z.detach(), loss.detach(), dict(zip(names, grads)), stats


@pytest.mark.parametrize("trained", [False, True], ids=["initial", "trained"])
@pytest.mark.parametrize("law", ["float32", "float64"], indirect=True)
def test_port_matches_the_reference(drawn, law, trained, monkeypatch):
    _no_recompute(monkeypatch)
    weights = drawn[trained]
    x = _episodes(30 + trained)
    z_ref, loss_ref, g_ref, stats_ref = _reference(weights, x, law)
    net = _port(weights, law)
    loss, stats = net.batch_loss_train(x)
    params = dict(net.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    with torch.no_grad():
        z, _ = net._features(x.reshape(-1, PX, PX, 3), train=True,
                             ep_groups=B)
    tol = TOL[law]
    assert z.dtype == z_ref.dtype == DTYPES[law]
    assert _rel(z, z_ref.reshape(z.shape)) < tol["features"]
    assert _rel(loss.detach(), loss_ref) < tol["loss"]
    assert set(grads) == set(g_ref)
    norms = sorted(float(g.norm()) for g in g_ref.values())
    median = norms[len(norms) // 2]
    gaps = {n: float((grads[n].double() - g.double()).norm())
            / max(float(g.norm()), median) for n, g in g_ref.items()}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < tol["grad"], (worst, gaps[worst])
    names = {m: n for n, m in net.named_modules()}
    assert {names[bn] for bn in stats} == set(stats_ref)
    assert len(stats) == 49 + 1  # the trunk's and bn_out
    for bn, (mean, var) in stats.items():
        want = stats_ref[names[bn]]
        assert _rel(mean, want[0]) < tol["running"], names[bn]
        assert _rel(var, want[1]) < tol["running"], names[bn]


def test_param_shapes_are_the_port_state_dict():
    port = {"feature." + k: tuple(v.shape)
            for k, v in model_dict["ResNet50"]().state_dict().items()}
    mine = trunk_ResNet50.param_shapes(224)
    assert list(mine) == list(port)
    assert {k: s for k, (s, _) in mine.items()} == port
    biases = {k for k, (_, kind) in mine.items() if kind == "conv_bias"}
    assert biases == {f"feature.trunk.{i}.C2.bias" for i in range(4, 20)}


def test_recompute_gives_a_plain_forward_gradients(drawn, monkeypatch):
    """Each block recomputed in the backward (torch.utils.checkpoint)
    against the same forward keeping its activations: the same gradients
    and running averages, bit for bit (one episode, float64)."""
    x = _episodes(40)[:1]

    def grads():
        return _reference(drawn[True], x, "float64")[2:]

    g_ckpt, s_ckpt = grads()
    _no_recompute(monkeypatch)
    g_plain, s_plain = grads()
    assert set(g_ckpt) == set(g_plain)
    for n, g in g_plain.items():
        assert torch.equal(g_ckpt[n], g), n
    assert set(s_ckpt) == set(s_plain)
    for n, (mean, var) in s_plain.items():
        assert torch.equal(s_ckpt[n][0], mean) and torch.equal(
            s_ckpt[n][1], var), n


def test_counts_by_hand():
    """53 convolutions and 4,087,136,256 multiply-adds an image at 224
    px; 49 trunk BatchNorms over 9,608,704 elements."""
    stem = 3 * 64 * 49 * 112 * 112
    macs = stem
    convs, bns, elements = 1, 1, 64 * 112 * 112
    side, cin = 56, 64
    for n, width in ((3, 256), (4, 512), (6, 1024), (3, 2048)):
        mid = width // 4
        for j in range(n):
            out = side // 2 if (width > 256 and j == 0) else side
            macs += (cin * mid * side * side + mid * mid * 9 * out * out
                     + mid * width * out * out)
            elements += mid * side * side + mid * out * out + width * out * out
            convs, bns = convs + 3, bns + 3
            if cin != width:
                macs += cin * width * out * out
                convs += 1
            side, cin = out, width
    assert (convs, macs, bns, elements) == (53, 4087136256, 49, 9608704)
    assert len(flops.conv_macs("ResNet50", 224)) == 53
    assert sum(flops.conv_macs("ResNet50", 224)) == macs
    assert flops.conv_macs("ResNet50", 224)[0] == stem
    shapes = trunk_ResNet50.bn_shapes(224)
    assert len(shapes) == 49
    assert sum(c * h * w for c, h, w in shapes) == elements
    assert trunk_ResNet50.feat_dim(224) == 2048


def test_batchnorm_layers_roofline_reader():
    """images x BatchNorm elements an image x 10 bytes at 3.35 TB/s over
    the episodic_bn_ kernels' device time a step; None where no such
    kernel ran, in eval mode, or for a trunk with no bn_shapes."""
    from dkt_bench.registry import Registry
    from dkt_bench.trace import Record

    reg = Registry()
    read = reg.reader("batchnorm_layers_roofline.train")
    cfg, tr = reg.config("dkt_resnet50_cub"), reg.traffic("train_5w5s16q_b8")
    kernels = [("void (anonymous namespace)::episodic_bn_stats(...)", 4e-3,
                ()), ("void (anonymous namespace)::episodic_bn_grad_apply"
                      "<true>(...)", 6e-3, ()), ("gram_kernel", 1.0, ())]
    want = 100 * 840 * 9608704 * 10 / 3.35e12 * 2 / 10e-3
    assert read(Record("train", cfg, tr, 2, 1.0, 0.9, kernels)) == \
        pytest.approx(want)
    assert read(Record("train", cfg, tr, 2, 1.0, 0.9, kernels[2:])) is None
    assert read(Record("eval", cfg, tr, 2, 1.0, 0.9, kernels)) is None
    conv4 = reg.config("dkt_conv4_miniimagenet")
    assert read(Record("train", conv4, tr, 2, 1.0, 0.9, kernels)) is None


@pytest.mark.parametrize("model,blocks,projections", [
    ("ResNet50", 16, 4), ("ResNet10", 4, 3)])
def test_block_and_residual_spans(drawn, model, blocks, projections):
    """A train step opens dkt.block once a residual block, and dkt.residual
    once inside each; the backward ops of the residual add and of the
    projection shortcuts carry the sequence numbers of forward ops inside
    dkt.residual, and dkt.block holds more of them."""
    if model == "ResNet50":
        net = _port(drawn[False], "float32")
    else:
        net = DKT(model_dict[model](), WAY, SHOT, "bncossim",
                  feature_dtype="float32", device="cpu").init(
            torch.zeros((WAY, SHOT + QUERY, PX, PX, 3), dtype=torch.uint8),
            _gen(0))
    events = _host_events(lambda: net.train_step(_episodes(50)))
    spans = _spans(events)
    assert len(spans["block"]) == len(spans["residual"]) == blocks
    for block, residual in zip(sorted(spans["block"]),
                               sorted(spans["residual"])):
        assert _within(residual, block) and _within(block, spans["trunk"][0])
    forward = {(thread, seq): start
               for _, start, _, seq, fwd_thread, thread in events
               if seq >= 0 and fwd_thread == 0}
    charged: dict = {"block": [], "residual": []}
    for name, _, _, seq, fwd_thread, _ in events:
        if name.startswith(BACKWARD) and seq >= 0:
            t = forward[(fwd_thread, seq)]
            for span, ops in charged.items():
                if any(a <= t <= b for a, b in spans[span]):
                    ops.append(name[len(BACKWARD):])
    residual = charged["residual"]
    assert residual.count("AddBackward0") >= blocks  # with BNshortcut's
    assert residual.count("ReluBackward0") == blocks
    assert residual.count("ConvolutionBackward0") == projections
    assert len(charged["block"]) > len(residual)
