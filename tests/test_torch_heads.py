"""The port's DKT test-time heads against the JAX package's, on the CPU:
per-episode GP adaptation (methods/dkt.py adapt_gp, batch_correct_adapted),
the Laplace head (gp/laplace.py, the batch_correct_laplace head), the
calibration metrics (utils/metrics.py) and the CLIs that run them
(test.py --laplace / --adaptation, test_uncertainty.py).

Tiny trunks as the JAX tests use them: ConvNetS(depth=2) at 16 px (1024
features), 5-way 2-shot 3-query, float32 trunk, weights carried across
with utils.convert.dkt_params_from_jax. The JAX package adapts through its
plain sum-MLL; the port's fused route (on CPU tensors the kernel's plain
version with per-episode parameters) and its plain route are both held to
it. Tolerances: adapted parameters 1e-4 relative to each leaf's largest
entry; per-episode accuracies equal; Laplace ids equal, its rescaled
scores 1e-4 absolute and its probabilities 1e-5; ECE 1e-6; the fitted
temperature 1e-4 relative.
"""
import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu import native as jnative
from deep_kernel_transfer_tpu_torch import native as tnative
from deep_kernel_transfer_tpu.gp import laplace as jlap
from deep_kernel_transfer_tpu.gp.kernels import sq_dist as jsq_dist
from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu.utils import metrics as jmetrics
from deep_kernel_transfer_tpu_torch import test as ttest
from deep_kernel_transfer_tpu_torch import test_uncertainty as ttu
from deep_kernel_transfer_tpu_torch import train as ttrain
from deep_kernel_transfer_tpu_torch.gp import laplace as tlap
from deep_kernel_transfer_tpu_torch.methods import DKT
from deep_kernel_transfer_tpu_torch.models import ConvNet
from deep_kernel_transfer_tpu_torch.utils import metrics as tmetrics
from deep_kernel_transfer_tpu_torch.utils.convert import dkt_params_from_jax
from torch_test_threads import one_thread  # noqa: F401

B, WAY, SHOT, QUERY, PX = 4, 5, 2, 3, 16
STEPS = 5


def _episodes(seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (B, WAY, SHOT + QUERY, PX, PX, 3)).astype(np.uint8)


def _pair(kernel_type="bncossim", fused=True):
    x = _episodes()
    jm = JDKT(jbb.ConvNetS(depth=2), WAY, SHOT, kernel_type,
              feature_dtype="float32")
    state = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    tm = DKT(ConvNet(2, first_channel=True), WAY, SHOT, kernel_type,
             feature_dtype="float32", use_fused_mll=fused,
             device="cpu").init(torch.from_numpy(x[0]))
    dkt_params_from_jax(jax.tree.map(np.asarray, state.params), tm, PX)
    return x, jm, state.params, tm


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("kernel_type", ["bncossim", "linear"])
def test_adapt_gp_matches_jax(kernel_type, fused):
    """Each episode's GP parameters after 5 Adam steps on its support MLL,
    all episodes in one batch on the port's side, one at a time on the JAX
    side."""
    x, jm, params, tm = _pair(kernel_type, fused)
    got = tm.adapt_gp(torch.from_numpy(x), STEPS)
    for b in range(B):
        want = jm.adapt_gp(params, jnp.asarray(x[b]), steps=STEPS)["gp"]
        leaves = jax.tree_util.tree_leaves_with_path(want)
        assert len(leaves) == (3 if kernel_type == "linear" else 2)
        for path, w in leaves:
            w = np.asarray(w)
            g = _leaf(got, path)
            assert g.shape == (B, WAY)
            assert np.abs(g[b].numpy() - w).max() < 1e-4 * np.abs(w).max()


def test_adapt_gp_leaves_the_model_untouched():
    x, _, _, tm = _pair()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt_state = dict(tm.optimizer.state)
    got = tm.adapt_gp(torch.from_numpy(x), STEPS)
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())
    assert dict(tm.optimizer.state) == opt_state
    assert not torch.equal(got["kernel"]["raw_outputscale"],
                           tm.gp.tree()["kernel"]["raw_outputscale"].expand(
                               B, -1))
    same = tm.adapt_gp(torch.from_numpy(x), 0)
    assert torch.equal(same["mean"]["constant"],
                       tm.gp.tree()["mean"]["constant"].expand(B, -1))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_batch_correct_adapted_matches_jax(fused):
    x, jm, params, tm = _pair(fused=fused)
    want = np.asarray(jm.batch_correct_adapted(params, jnp.asarray(x),
                                               STEPS))
    got = tm.batch_correct_adapted(torch.from_numpy(x), STEPS).numpy()
    assert got.shape == (B,)
    np.testing.assert_array_equal(got, want)


def test_adaptation_runs_one_fused_mll_a_step(monkeypatch):
    """The fused route takes every episode of the batch in one call of the
    kernel's wrapper a step, with scales [B, W] and diffs [B, W, N]."""
    from deep_kernel_transfer_tpu_torch.methods import dkt as tdkt

    x, _, _, tm = _pair()
    shapes = []
    real = tdkt.fused_linear_mll

    def spy(z, diffs, scales, *a, **k):
        shapes.append((tuple(z.shape), tuple(diffs.shape),
                       tuple(scales.shape)))
        return real(z, diffs, scales, *a, **k)

    monkeypatch.setattr(tdkt, "fused_linear_mll", spy)
    tm.adapt_gp(torch.from_numpy(x), STEPS)
    n = WAY * SHOT
    assert shapes == [((B, n, 1024), (B, WAY, n), (B, WAY))] * STEPS


def test_batch_correct_laplace_matches_jax():
    x, jm, params, tm = _pair()
    want = np.asarray(jm.batch_correct_laplace(params, jnp.asarray(x)))
    got = tm.batch_correct_laplace(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tm.correct_laplace(torch.from_numpy(x[1])) == jm.correct_laplace(
        params, jnp.asarray(x[1]))


def _features(n_way=4, n_per=3, n_query=12, d=16, seed=0, far=0.0):
    """Unit-norm support features around per-way centres and queries;
    `far` pushes the queries away from every support (the band where an
    f32 sigmoid saturates)."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(n_way, d)
    zs = np.repeat(centres, n_per, 0) + 0.4 * rng.randn(n_way * n_per, d)
    zq = centres[rng.randint(0, n_way, n_query)] + 0.4 * rng.randn(n_query, d)
    zq = zq + far * rng.randn(n_query, d)
    zs /= np.linalg.norm(zs, axis=-1, keepdims=True)
    zq /= np.linalg.norm(zq, axis=-1, keepdims=True)
    return (zs.astype(np.float32), np.repeat(np.arange(n_way), n_per),
            zq.astype(np.float32))


def _jax_ovr_scores(zs, ys, zq, n_way, ls=0.1, n_iters=30):
    """The rescaled scores of the JAX head (laplace.py:125-146), from its
    own functions."""
    ls2 = ls * ls
    targets = (ys[None, :] == jnp.arange(n_way)[:, None]).astype(zs.dtype)
    k = jlap.rbf_gram(zs, zs, ls)
    d2q = jsq_dist(zs, zq)
    d2min = jnp.min(d2q, axis=0)
    k_tilde = jnp.exp(-0.5 * (d2q - d2min[None, :]) / ls2)
    m2 = jnp.exp(-d2min / ls2)

    def one(t):
        f, v = jlap._mode_project(k, t, k_tilde, n_iters)
        return f / jnp.sqrt(1.0 + jnp.pi * jnp.maximum(1.0 - m2 * v, 1e-10)
                            / 8.0)

    return jax.vmap(one)(targets)


@pytest.mark.parametrize("far", [0.0, 3.0])
def test_laplace_ovr_matches_jax(far):
    """Three episodes in one batched call against the JAX head one episode
    at a time: ids equal, rescaled scores 1e-4 absolute. far=3 puts the
    queries where k* underflows f32."""
    eps = [_features(seed=s, far=far) for s in range(3)]
    zs = torch.from_numpy(np.stack([e[0] for e in eps]))
    zq = torch.from_numpy(np.stack([e[2] for e in eps]))
    ys = torch.from_numpy(eps[0][1])
    got_ids = tlap.laplace_ovr_predict(zs, ys, zq, 4).numpy()
    got_scores = tlap.laplace_ovr_scores(zs, ys, zq, 4).numpy()
    assert got_scores.shape == (3, 4, 12)
    for i, (s, y, q) in enumerate(eps):
        args = (jnp.asarray(s), jnp.asarray(y), jnp.asarray(q))
        want_ids = np.asarray(jlap.laplace_ovr_predict(*args, n_way=4))
        want_scores = np.asarray(_jax_ovr_scores(*args, 4))
        np.testing.assert_array_equal(want_scores.argmax(0), want_ids)
        np.testing.assert_array_equal(got_ids[i], want_ids)
        assert np.abs(got_scores[i] - want_scores).max() < 1e-4
    if far:  # the far band really is beyond a naive f32 probability
        k_star = np.exp(-50.0 * ((eps[0][0][:, None] - eps[0][2][None]) ** 2
                                 ).sum(-1)).astype(np.float32)
        assert (k_star.max(0) < 1e-7).any()


def test_laplace_predict_proba_matches_jax():
    zs, ys, zq = _features(n_way=2, n_per=6, seed=4)
    t = (ys == 1).astype(np.float32)
    want = np.asarray(jlap.laplace_predict_proba(
        jnp.asarray(zs), jnp.asarray(t), jnp.asarray(zq), lengthscale=0.5))
    got = tlap.laplace_predict_proba(torch.from_numpy(zs), torch.from_numpy(t),
                                     torch.from_numpy(zq),
                                     lengthscale=0.5).numpy()
    assert np.abs(got - want).max() < 1e-5
    assert ((got > 0) & (got < 1)).all() and got.std() > 0.05


def _logits(seed=0, n=600, w=5):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, w, n)
    logits = rng.randn(n, w) * 0.5
    logits[np.arange(n), labels] += rng.rand(n) * 2.0
    return logits.astype(np.float32), labels


@pytest.mark.parametrize("one_vs_rest", [True, False])
@pytest.mark.parametrize("temperature", [1.0, 0.4])
def test_ece_matches_jax(one_vs_rest, temperature):
    logits, labels = _logits()
    want = jmetrics.ece(logits, labels, temperature, one_vs_rest=one_vs_rest)
    got = tmetrics.ece(logits, labels, temperature, one_vs_rest=one_vs_rest)
    assert abs(got - want) < 1e-6 and 0.0 < got < 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_calibrate_temperature_matches_jax(seed):
    logits, labels = _logits(seed)
    logits = logits * (3.0 if seed else 0.3)  # over- and under-confident
    want = jmetrics.calibrate_temperature(logits, labels)
    got = tmetrics.calibrate_temperature(logits, labels)
    assert abs(got - want) < 1e-4 * want
    assert abs(np.log(got)) > 0.1


def test_numpy_metrics_match_jax():
    rng = np.random.RandomState(0)
    cl = {c: rng.randn(6, 5) * (rng.rand(6, 5) > 0.3) + c for c in range(4)}
    y = rng.randint(0, 4, 10)
    np.testing.assert_array_equal(tmetrics.one_hot(y, 4),
                                  jmetrics.one_hot(y, 4))
    assert tmetrics.DBindex(cl) == jmetrics.DBindex(cl)
    assert tmetrics.sparsity(cl) == jmetrics.sparsity(cl)


# -- the CLIs ----------------------------------------------------------------

CLI = ["--dataset=omniglot", "--model=Conv4", "--method=DKT",
       "--train_n_way=3", "--test_n_way=3", "--n_shot=2", "--seed=1",
       "--feature_dtype=float32"]


@pytest.fixture(scope="module")
def trained_cwd(tmp_path_factory):
    """A tiny omniglot-layout set (6 classes of 20 faintly signed 28-px
    JPEGs) and a port checkpoint after one short epoch; both packages'
    native decoders are switched off."""
    import os

    root = tmp_path_factory.mktemp("heads_cli")
    img_dir = root / "filelists" / "omniglot" / "images"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    names, labels = [], []
    for cl in range(6):
        for i in range(20):
            arr = (rng.rand(28, 28, 3) * 120).astype(np.uint8)
            r, c = divmod(cl, 3)
            arr[r * 12:r * 12 + 10, c * 9:c * 9 + 8] += 40
            p = img_dir / f"c{cl}_{i}.jpg"
            Image.fromarray(arr).save(p)
            names.append(str(p))
            labels.append(cl)
    for split in ("base", "val", "novel"):
        with open(root / "filelists" / "omniglot" / f"{split}.json", "w") as f:
            json.dump({"label_names": [f"c{i}" for i in range(6)],
                       "image_names": names, "image_labels": labels}, f)
    old = os.getcwd()
    os.chdir(root)
    try:
        with pytest.MonkeyPatch.context() as mp:
            # the JAX side decodes through PIL too, as the port does
            mp.setattr(jnative, "available", lambda: False)
            mp.setattr(tnative, "available", lambda: False)
            ttrain.main(CLI + ["--stop_epoch=1", "--n_train_episodes=6",
                               "--device_data=off"], device="cpu")
            yield root
    finally:
        os.chdir(old)


@pytest.mark.parametrize("head", ["--laplace", "--adaptation"])
def test_test_cli_heads_match_jax_test_cli(trained_cwd, head):
    """The port's test.py with a head against the JAX test.py on the same
    checkpoint and episodes (host loader): the same accuracy, and the
    results line with the -adapted tag for --adaptation."""
    import test as jtest

    args = CLI + ["--device_data=off", "--repeat=1", "--n_iter=4", head]
    got = ttest.main(args, device="cpu")
    want = jtest.main(args)
    assert abs(got[0] - want[0]) < 1e-4 and abs(got[1] - want[1]) < 1e-4
    line = open("record/results.txt").read().splitlines()[-2]
    tag = "-adapted" if head == "--adaptation" else ""
    assert f"omniglot-Conv4S-DKT{tag} 2shot 3way_test" in line


def test_test_uncertainty_cli(trained_cwd):
    """Both phases on the device-data path: a finite temperature, ECEs in
    [0, 1], the JAX module's return keys."""
    out = ttu.main(CLI + ["--device_data=on", "--repeat=2", "--n_iter=6",
                          "--episode_batch=4"], device="cpu")
    assert set(out) == {"ece_raw", "ece_raw_std", "ece_cal", "ece_cal_std",
                        "temperature", "acc"}
    assert 0.0 <= out["ece_raw"] <= 1.0 and 0.0 <= out["ece_cal"] <= 1.0
    assert np.isfinite(out["temperature"]) and out["temperature"] > 0
    assert 0.0 <= out["acc"] <= 100.0
    # protonet collects from the save_features cache, not written here
    with pytest.raises(FileNotFoundError, match="save_features"):
        ttu.main(["--method=protonet"], device="cpu")
