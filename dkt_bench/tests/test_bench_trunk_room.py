"""A trunk that is not a stack of convolutions enters as a file of its own:
the weight laws of linear, LayerNorm and bias-table leaves, a kind the trunk
draws itself, model FLOPs from the trunk's own products, and the reference's
training steps, on a stub transformer trunk (stub_trunk.py) that nothing
under dkt_bench/ knows by name. Beside them, the draws and the model FLOPs of
the benchmark's own configurations, pinned to the values they had before
the laws became a table."""
from __future__ import annotations

import hashlib
import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch

from dkt_bench import flops
from dkt_bench.reference import dkt as ref
from dkt_bench.registry import Registry

STUB = "dkt_bench.reference.trunk_Stub"
CFG = {"model": "Stub", "image_size": 16, "gp_noise": 0.1, "gp_lr": 1e-4,
       "feature_lr": 1e-3, "adam": {"betas": [0.9, 0.999], "eps": 1e-8}}
TRAFFIC = {"mode": "train", "n_way": 5, "n_support": 2, "n_query": 2,
           "episode_batch": 2, "augment": True}

# sha256 over each leaf's name and the sha256 of its float32 bytes, in
# layout order, of draw_weights(cfg, 5, torch.Generator().manual_seed(
# 20260422), "cpu", trained) on this CPU torch; recorded from the draws
# of the commit before LAWS
DRAWS = {
    ("dkt_conv4_miniimagenet", False):
        "7b0d39e007d46c7f80073daeaa75c4e32b231c51a8d5d4217ec13660297ab715",
    ("dkt_conv4_miniimagenet", True):
        "b2d2510cc35304db30c3bf43a00fe8f4866f9dced8dd2ce36031061c0b6e45ee",
    ("dkt_resnet10_cub", False):
        "7dac430f31a5a017d4f7f2c6c001b481710c7930a0cd3abc764283ee88c60110",
    ("dkt_resnet10_cub", True):
        "9ec0b74a282339e773ca51dd5d4b107c15231756579ec2f1ca0958fed96e4c5a",
    ("dkt_resnet50_cub", False):
        "bda8bb82e4d819285499c38816ac1c7d12b41d00dad47265ac91da06fbdd9d8e",
    ("dkt_resnet50_cub", True):
        "c7ef612e9ded06549fc6ee960be56831a35e9f04222313e4535d040d95e44d23",
}
# train_step_flops (train cells) and protocol_flops (the eval cell) before
# trunk_macs, the yardstick of mfu.train and mfu.eval
CELL_FLOPS = {
    "conv4_mini_train_b32": 1877593509120.0,
    "resnet10_cub_train_b16": 8561898307200.0,
    "conv4_mini_eval_b32": 11664514560000.0,
    "resnet50_cub_train_b8": 20401117396800.0,
}


@pytest.fixture
def stub(monkeypatch):
    """stub_trunk.py as reference.dkt finds a trunk: the module
    dkt_bench.reference.trunk_Stub."""
    path = Path(__file__).with_name("stub_trunk.py")
    spec = importlib.util.spec_from_file_location(STUB, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setitem(sys.modules, STUB, module)
    return module


def _draw(trained, seed=3):
    return ref.draw_weights(CFG, 5, torch.Generator().manual_seed(seed),
                            "cpu", trained=trained)


def _slices(seed=3) -> dict:
    """name -> (z, u): each leaf's own slices of draw_weights' two draws."""
    shapes = ref.layout(CFG, 5)
    sizes = [torch.Size(s).numel() for s, _ in shapes.values()]
    gen = torch.Generator().manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen)
    uniform = torch.rand(sum(sizes), generator=gen)
    out, at = {}, 0
    for (name, (shape, _)), n in zip(shapes.items(), sizes):
        out[name] = (normal[at:at + n].view(shape),
                     uniform[at:at + n].view(shape))
        at += n
    return out


def _of_kind(stub, w, kind):
    return torch.cat([w[n].flatten() for n, (_, k) in
                      stub.param_shapes(16).items() if k == kind])


@pytest.mark.parametrize("trained", [False, True])
def test_transformer_kinds_draw_by_their_laws(stub, trained):
    w = _draw(trained)
    assert set(w) == set(ref.layout(CFG, 5))
    x = _of_kind(stub, w, "linear")  # 12288 draws
    assert x.numel() >= 10 ** 4 and 0.017 <= float(x.std()) <= 0.023
    assert abs(float(x.mean())) < 0.001
    z, _ = _slices()["feature.trunk.bias_table"]
    assert torch.equal(w["feature.trunk.bias_table"], 0.02 * z)
    scales = _of_kind(stub, w, "ln_weight")
    shifts = _of_kind(stub, w, "ln_bias")
    biases = _of_kind(stub, w, "linear_bias")
    if trained:
        assert 0.5 <= float(scales.min()) and float(scales.max()) <= 1.5
        assert float(scales.std()) > 0.2  # U(0.5, 1.5): 0.289
        assert 0.05 < float(shifts.std()) < 0.15
        assert 0.005 < float(biases.std()) < 0.015
    else:
        assert torch.equal(scales, torch.ones_like(scales))
        assert not shifts.any() and not biases.any()
    for name, (shape, _) in ref.layout(CFG, 5).items():
        assert w[name].shape == shape and w[name].dtype == torch.float32


def test_trunk_kind_takes_its_own_slices_of_the_draws(stub):
    """The stub's `stub_scale` leaf comes from its draw_leaf, fed the
    leaf's own slice of the uniform draw."""
    name = "feature.trunk.scale"
    _, u = _slices()[name]
    assert torch.equal(_draw(True)[name], 0.25 + 0.5 * u)
    assert torch.equal(_draw(False)[name], torch.full_like(u, 0.5))


def test_unknown_kind_raises_naming_the_leaf(stub, monkeypatch):
    shapes = stub.param_shapes

    def odd(size):
        return {**shapes(size), "feature.trunk.odd": ((3,), "odd_kind")}

    monkeypatch.setattr(stub, "param_shapes", odd)
    for trained in (False, True):
        with pytest.raises(KeyError, match="feature.trunk.odd.*odd_kind"):
            _draw(trained)
    monkeypatch.setattr(stub, "param_shapes", shapes)
    monkeypatch.delattr(stub, "draw_leaf")  # its own kind, with no draw_leaf
    with pytest.raises(KeyError, match="feature.trunk.scale.*stub_scale"):
        _draw(False)


def test_stub_flops_by_hand(stub):
    # 16 px, 16 tokens of 32 channels, windows of 4 tokens
    patch = 16 * 32 * 3 * 4 * 4          # the 4x4/4 convolution
    qkv = 16 * 32 * 96
    scores = attend = 16 * 4 * 32        # Q K^T and A V: T M^2 C
    proj = 16 * 32 * 32
    mlp = 2 * 16 * 32 * 128
    total = patch + qkv + scores + attend + proj + mlp
    assert total == 225280
    assert flops.trunk_macs("Stub", 16) == [patch, qkv, scores, attend, proj,
                                            mlp // 2, mlp // 2]
    assert flops.trunk_forward_flops("Stub", 16) == 2 * total
    assert flops.trunk_train_flops("Stub", 16) == 2 * (3 * total - patch)
    assert flops.conv_macs("Conv4", 84) == flops.trunk_macs("Conv4", 84)
    n = 5 * 4
    assert flops.train_step_flops(CFG, TRAFFIC) == (
        2 * n * 2 * (3 * total - patch) + flops.fused_mll_flops(2, n, 32, 5))


@pytest.mark.parametrize("law", ["stated", "control"])
def test_stub_trains_through_the_reference(stub, law):
    split = ref.make_split({"n_class": 8, "per_class": 6, "side": 18},
                           torch.Generator().manual_seed(4), "cpu")
    w = _draw(False)
    out = ref.train_steps(CFG, TRAFFIC, w, split, 5, 2, law=law,
                          exact_episodes=1)
    losses = out["losses"]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert losses[0] != losses[1]
    for g in list(out["grad1"].values()) + list(out["grad_exact"].values()):
        assert torch.isfinite(g).all()
    assert out["grad_exact"]["feature.trunk.qkv.weight"].dtype == torch.float64
    moved = {n for n in ref.trainable(CFG, 5)
             if not torch.equal(out["params"][n], w[n])}
    assert {"feature.trunk.bias_table", "feature.trunk.scale",
            "feature.trunk.fc2.weight"} <= moved


def _digest(weights: dict) -> str:
    h = hashlib.sha256()
    for name, v in weights.items():
        h.update(name.encode())
        h.update(hashlib.sha256(v.contiguous().numpy().tobytes()).digest())
    return h.hexdigest()


@pytest.mark.parametrize("name,trained", sorted(DRAWS))
def test_configs_draw_as_before(name, trained):
    cfg = Registry().config(name)
    w = ref.draw_weights(cfg, 5, torch.Generator().manual_seed(20260422),
                         "cpu", trained=trained)
    assert _digest(w) == DRAWS[(name, trained)]


@pytest.mark.parametrize("cell", sorted(CELL_FLOPS))
def test_cells_count_the_flops_they_counted(cell):
    reg = Registry()
    w = reg.cell(cell)
    cfg, tr = reg.config(w["config"]), reg.traffic(w["traffic"])
    count = (flops.train_step_flops(cfg, tr) if tr["mode"] == "train"
             else flops.protocol_flops(cfg, tr))
    assert count == CELL_FLOPS[cell]
