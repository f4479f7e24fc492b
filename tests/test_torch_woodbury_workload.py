"""The port's Woodbury CLI workload
(deep_kernel_transfer_tpu_torch/benchmarks/woodbury_workload.py) against
the JAX package's benchmarks/woodbury_workload.py and DKT, on the CPU:

  (a) the glyph generator draws the JAX one's pixels from RandomState(23),
      and make_glyph_filelists writes the JAX script's files and split
      JSONs byte for byte (250 classes, 2 images a class here);
  (b) one DKT train step at the workload's width, 20-way 15-shot with 16
      queries (N = 620 a way-GP, the Woodbury MLL), B = 2, Conv4S at 28
      px on glyph episodes, f32 trunk, the JAX init carried over by
      utils/convert.py: the loss within 1e-5 absolute and every gradient
      within 2e-2 of its largest entry (that scale floored at 1e-4, as in
      tests/test_torch_dkt.py) of the JAX DKT's, a conv bias before a
      train-mode BatchNorm (exact gradient 0) below 1e-3 of its conv
      weight's (tests/test_torch_methods_zoo.py); the force_dense arm
      (the dense N x N route) within 1e-4 relative of the routed arm's
      loss and its gradients by the same rule; no call of the fused MLL,
      whose N <= 128 the workload exceeds;
  (c) batch_correct at 20-way 15-shot 15-query (N = 300 support, the
      Woodbury posterior) equal to the JAX DKT's accuracies (the same
      count of correct queries; the percentages within f32 rounding of
      the mean), on both arms, and the routes that ExactGP takes recorded
      by the runner.
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu_torch.benchmarks import woodbury_workload as tww
from deep_kernel_transfer_tpu_torch.methods import DKT
from deep_kernel_transfer_tpu_torch.methods import dkt as tdkt
from deep_kernel_transfer_tpu_torch.models import Conv4S
from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll
from deep_kernel_transfer_tpu_torch.utils.convert import (
    dkt_params_from_jax, dkt_state_from_jax)
from torch_test_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAY, SHOT, QUERY, PX, B = 20, 15, 16, 28, 2


@pytest.fixture(scope="module")
def jww():
    """The JAX package's benchmarks/woodbury_workload.py, imported with
    benchmarks/ first on sys.path, as running the script puts it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(os.path.join(REPO, "benchmarks"))
        yield importlib.import_module("woodbury_workload")


def _glyph_episodes(b: int, n_total: int, seed: int = 5) -> np.ndarray:
    """[b, WAY, n_total, PX, PX, 3] uint8 episodes of glyph classes drawn
    by the workload's generator, grey in all three channels."""
    rng = np.random.RandomState(seed)
    eps = np.stack([np.stack(tww._render_glyph_class(rng, n_total))
                    for _ in range(b * WAY)])
    eps = eps.reshape(b, WAY, n_total, PX, PX)
    return np.repeat(eps[..., None], 3, axis=-1)


# -- (a) the data -------------------------------------------------------------

def test_glyph_pixels_equal_the_jax_generator(jww):
    jrng, trng = np.random.RandomState(23), np.random.RandomState(23)
    for _ in range(3):
        want = jww._render_glyph_class(jrng, 40)
        got = tww._render_glyph_class(trng, 40)
        assert len(got) == len(want) == 40
        for g, w in zip(got, want):
            assert g.dtype == np.uint8 and g.shape == (PX, PX)
            np.testing.assert_array_equal(g, w)


def _tree(root) -> dict:
    """{relative path: bytes} of every file under root/filelists, with the
    root's path taken out of the JSONs."""
    out = {}
    base = os.path.join(root, "filelists")
    for d, _, files in os.walk(base):
        for name in files:
            p = os.path.join(d, name)
            data = open(p, "rb").read()
            if name.endswith(".json"):
                data = data.replace(str(root).encode(), b"<root>")
            out[os.path.relpath(p, base)] = data
    return out


def test_glyph_filelists_byte_equal_to_jax(jww, tmp_path):
    jww.make_glyph_filelists(str(tmp_path / "jax"), n_img=2)
    tww.make_glyph_filelists(str(tmp_path / "port"), n_img=2)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(got) == 250 * 2 + 3 + 1  # images, splits, sentinel
    assert set(got) == set(want)
    for name, data in want.items():
        assert got[name] == data, name
    splits = {s: json.loads(got[f"omniglot/{s}.json"])
              for s in ("base", "val", "novel")}
    assert [len(set(v["image_labels"])) for v in splits.values()] == [
        200, 25, 25]


# -- (b) the train step -------------------------------------------------------

@pytest.fixture(scope="module")
def step():
    """The JAX loss and gradients of one step on the workload's episodes,
    and the port's on the routed and the force_dense arm, from one JAX
    init; the fused MLL's calls on the port's side counted."""
    x = _glyph_episodes(B, SHOT + QUERY)
    jm = JDKT(jbb.Conv4S(), WAY, SHOT, "bncossim", feature_dtype="float32",
              force_dense=False)
    state = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    assert jm.gp._use_low_rank(state.params["gp"],
                               jnp.zeros((WAY * (SHOT + QUERY), 64)))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.batch_loss_train, has_aux=True))(state.params, jnp.asarray(x))
    calls = []
    out = {"jloss": float(jloss)}

    def counted(*args, **kwargs):
        calls.append(1)
        return fused_linear_mll(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdkt, "fused_linear_mll", counted)
        fused_linear_mll.launches = 0
        for arm in ("woodbury", "dense"):
            tm = DKT(Conv4S(), WAY, SHOT, "bncossim", feature_dtype="float32",
                     force_dense=(arm == "dense"), device="cpu").init(
                         torch.from_numpy(x[0]))
            dkt_params_from_jax(jax.tree.map(np.asarray, state.params), tm,
                                PX)
            with tww.recorded_routes() as seen:
                loss, _ = tm.batch_loss_train(torch.from_numpy(x))
                tm.zero_grad()
                loss.backward()
            out[arm] = {"loss": float(loss.detach()), "routes": seen,
                        "grads": {n: p.grad.numpy().copy()
                                  for n, p in tm.named_parameters()}}
    out["tm"] = tm
    out["jgrads"] = dkt_state_from_jax(
        {"feature": {"params": jax.tree.map(np.asarray,
                                            jgrads["feature"]["params"])},
         "gp": jax.tree.map(np.asarray, jgrads["gp"])}, tm, PX)
    out["calls"], out["launches"] = len(calls), fused_linear_mll.launches
    return out


def test_train_step_loss_matches_jax(step):
    assert abs(step["woodbury"]["loss"] - step["jloss"]) < 1e-5


def _grads_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if name.endswith(".C.bias"):
            scale = np.abs(want[name[:-4] + "weight"]).max()
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-3 * scale, name
        else:
            scale = max(np.abs(w).max(), 1e-4)
            assert np.abs(g - w).max() < 2e-2 * scale, name


def test_train_step_gradients_match_jax(step):
    _grads_close(step["woodbury"]["grads"], step["jgrads"])


def test_train_step_routes_and_dense_arm_agrees(step):
    assert set(step["woodbury"]["routes"]) == {(WAY * (SHOT + QUERY), True)}
    assert set(step["dense"]["routes"]) == {(WAY * (SHOT + QUERY), False)}
    a, b = step["woodbury"], step["dense"]
    assert abs(a["loss"] - b["loss"]) < 1e-4 * abs(b["loss"])
    _grads_close(a["grads"], b["grads"])


def test_train_step_never_calls_the_fused_mll(step):
    assert step["calls"] == 0 and step["launches"] == 0


# -- (c) the eval -------------------------------------------------------------

@pytest.mark.parametrize("arm", ["woodbury", "dense"])
def test_batch_correct_matches_jax(arm):
    x = _glyph_episodes(B, SHOT + 15, seed=6)
    jm = JDKT(jbb.Conv4S(), WAY, SHOT, "bncossim", feature_dtype="float32",
              force_dense=(arm == "dense"))
    state = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[0]))
    want = np.asarray(jm.batch_correct(state.params, jnp.asarray(x)))
    tm = DKT(Conv4S(), WAY, SHOT, "bncossim", feature_dtype="float32",
             force_dense=(arm == "dense"), device="cpu").init(
                 torch.from_numpy(x[0]))
    dkt_params_from_jax(jax.tree.map(np.asarray, state.params), tm, PX)
    with tww.recorded_routes() as seen:
        got = tm.batch_correct(torch.from_numpy(x)).numpy()
    assert tww.check_routes(seen, arm == "woodbury", (WAY * SHOT,)) == {
        WAY * SHOT: arm}
    assert got.shape == (B,)
    n_query = WAY * 15
    np.testing.assert_array_equal(np.round(got * n_query / 100),
                                  np.round(want * n_query / 100))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got > 100.0 / WAY).all()  # the glyph classes separate
