"""The plain reference against the port, part by part, at tiny sizes on
the CPU (the port's CPU paths: its plain fused-MLL version, its torch
augmentation and sampler)."""
from __future__ import annotations

import pytest
import torch

from dkt_bench.reference import common, dkt as ref
from dkt_bench.reference.common import mix


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_sampling_matches_the_port():
    from deep_kernel_transfer_tpu_torch.data.device_dataset import _sample_ids

    split = ref.make_split({"n_class": 9, "per_class": 7, "side": 4},
                           _gen(1), "cpu")
    for k in (3, 7, 12):  # without and with replacement
        a = common.sample_ids(split["table"], split["counts"], _gen(2), 5, k, 4)
        b = _sample_ids(split["table"], split["counts"], _gen(2), 5, k, 4)
        assert torch.equal(a, b)
        assert a.shape == (4, 5, k)


def test_augmentation_matches_the_port():
    from deep_kernel_transfer_tpu_torch.data.device_aug import augment

    x = torch.randint(0, 256, (6, 2, 23, 23, 3), generator=_gen(3),
                      dtype=torch.uint8)
    flat = x.reshape(-1, 23, 23, 3)
    mine = common.augment(flat, common.augment_draws(_gen(4), 12, 23, 20,
                                                     "cpu"), 20)
    port = augment(_gen(4), x, 20).reshape(-1, 20, 20, 3)
    assert (mine.int() - port.int()).abs().max() <= 1


def test_control_resampling_is_coarser():
    x = torch.randint(0, 256, (8, 23, 23, 3), generator=_gen(5),
                      dtype=torch.uint8)
    draws = common.augment_draws(_gen(6), 8, 23, 20, "cpu")
    a = common.augment(x, draws, 20)
    b = common.augment(x, draws, 20, law="control")
    assert (a.int() - b.int()).abs().max() >= 1


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -10])
    assert common.tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -1.0 - 2 ** -10]


def test_mll_matches_the_port():
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import \
        fused_linear_mll_plain

    z = torch.nn.functional.normalize(torch.randn(3, 20, 16,
                                                  generator=_gen(7)), dim=-1)
    p = {"gp.mean.constant": 0.1 * torch.randn(5, generator=_gen(8)),
         "gp.kernel.raw_outputscale": torch.randn(5, generator=_gen(9))}
    mine = common.gp_mll(p, z, 5, 4, 0.1, "stated")
    y = common.ovr_targets(5, 4, "cpu") - p["gp.mean.constant"][:, None]
    s = torch.nn.functional.softplus(p["gp.kernel.raw_outputscale"])
    port = fused_linear_mll_plain(z, y, s, 20, 0.1, jitter=0.0)
    torch.testing.assert_close(mine, port, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model,size", [("Conv4", 16), ("ResNet10", 32)])
def test_trunk_and_head_match_the_port(model, size):
    """Train- and eval-mode features and the running averages, from the
    same drawn weights, to bfloat16 rounding."""
    from deep_kernel_transfer_tpu_torch.methods.dkt import DKT
    from deep_kernel_transfer_tpu_torch.models.backbones import model_dict

    cfg = {"model": model, "image_size": size}
    w = ref.draw_weights(cfg, 5, _gen(10), "cpu", trained=True)
    net = DKT(model_dict[model](), 5, 2, device="cpu")
    net.init(torch.zeros((5, 4, size, size, 3), dtype=torch.uint8))
    net.load_state_dict(w, strict=True)
    x = torch.randint(0, 256, (2, 5, 4, size, size, 3), generator=_gen(11),
                      dtype=torch.uint8)
    for train in (True, False):
        stats = {}
        mine = ref.features(cfg, w, x, train, "stated", stats)
        z, port_stats = net._features(x.reshape(-1, size, size, 3), train,
                                      ep_groups=2 if train else 1)
        torch.testing.assert_close(mine, z.reshape(mine.shape), rtol=0.05,
                                   atol=0.02)
        if train:
            names = {m: n for n, m in net.named_modules()}
            for bn, (mean, var) in port_stats.items():
                name = "feature." + names[bn].removeprefix("feature.")
                torch.testing.assert_close(stats[name][0], mean, rtol=0.02,
                                           atol=0.02)
                torch.testing.assert_close(stats[name][1], var, rtol=0.02,
                                           atol=0.02)


def test_float64_gradient_finds_the_unmoved_leaves():
    """A conv bias under a training-mode BatchNorm reads nought in
    float64 and falls under the thousandth rule of check.py; every
    ResNet10 leaf stays."""
    import statistics

    tr = {"n_way": 5, "n_support": 2, "n_query": 2}
    for model, size, out in (("Conv4", 16, True), ("ResNet10", 32, False)):
        cfg = {"model": model, "image_size": size, "gp_noise": 0.1}
        w = ref.draw_weights(cfg, 5, _gen(12), "cpu")
        x = torch.randint(0, 256, (2, 5, 4, size, size, 3), generator=_gen(13),
                          dtype=torch.uint8)
        g = {n: float(v.norm()) for n, v in
             ref.exact_grad(cfg, tr, w, x).items()}
        med = statistics.median(g.values())
        left_out = {n for n, v in g.items() if v < 1e-3 * med}
        biases = {n for n in g if n.endswith(".C.bias")}
        assert biases <= left_out and (biases != set()) == out
        assert all(v > 1e-3 * med for n, v in g.items()
                   if n.endswith(".weight") and ".C" in n)
        assert "gp.mean.constant" not in left_out


def test_seed_streams_differ_and_fit():
    seeds = {mix(2 ** 31 + 5, s) for s in range(200)}
    assert len(seeds) == 200 and max(seeds) < 2 ** 63
    assert mix(7, 1) == mix(7, 1)
