"""The port's float64 copy of scikit-learn's Laplace GP classifier
(deep_kernel_transfer_tpu_torch/benchmarks/sklearn_gpc.py) against
scikit-learn itself, and the port's Laplace probe
(benchmarks/laplace_probe.py) against the JAX probe's arms.

The classifier is the reference's --laplace head:
GaussianProcessClassifier(1.0 * RBF(0.1), optimizer=None), one-vs-rest.
Cases: unit-norm features clustered by class at 1 and 5 shots and
D = 64 and 1600, and a "far" case whose queries sit in the f32 underflow
band of `tests/test_laplace.py::test_ovr_underflow_band_matches_f64`.
Each binary model's positive-class probability and the normalised
one-vs-rest probabilities agree within 1e-10 absolute, and the
predictions are identical.

The probe's arms run at the JAX tests' tiny trunk (ConvNetS(depth=2),
16 px) on the JAX weights, against the JAX probe's loop body
(benchmarks/laplace_probe.py:78-103: the JAX `laplace_ovr_predict`,
scikit-learn's classifier, the JAX `episode_scores`, the JAX
`rbf_gram`) on the same episodes: the accuracies of the three arms
equal; the Gram's off-diagonal mean, which both probes take as the f32
sum of the n x n Gram less its trace, within 1e-5 relative (f32 features
from two frameworks) plus 8 ulps of that sum, whose unit diagonal makes
it about n, over the n^2 - n entries.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sklearn.gaussian_process import GaussianProcessClassifier as SkGPC
from sklearn.gaussian_process.kernels import RBF
from sklearn.gaussian_process.kernels import ConstantKernel as C

from deep_kernel_transfer_tpu.gp.laplace import laplace_ovr_predict, rbf_gram
from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.methods.base import (episode_labels,
                                                   flatten_episode)
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu_torch.benchmarks import laplace_probe
from deep_kernel_transfer_tpu_torch.benchmarks.sklearn_gpc import \
    GaussianProcessClassifier
from deep_kernel_transfer_tpu_torch.methods import DKT
from deep_kernel_transfer_tpu_torch.models import ConvNet
from deep_kernel_transfer_tpu_torch.utils.convert import dkt_params_from_jax

WAY, QUERY = 5, 15
PROBA = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (the suite runs several
    test processes side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _clustered(shot: int, d: int, seed: int):
    """Support and query features around 5 class centres that share a
    common direction: support-support and query-support distances span
    the RBF(0.1) kernel's live range (d^2 from about 0.02 to 0.8)."""
    rng = np.random.RandomState(seed)
    centres = _unit(_unit(rng.randn(d)) + 0.8 * _unit(rng.randn(WAY, d)))

    def draw(n, spread):
        return _unit(np.repeat(centres, n, 0) + spread * _unit(
            rng.randn(WAY * n, d)))
    return draw(shot, 0.15), np.repeat(np.arange(WAY), shot), draw(QUERY, 0.2)


def _far():
    """tests/test_laplace.py::test_ovr_underflow_band_matches_f64's
    episode: every query d^2 > 0.3 from its nearest support."""
    rng = np.random.RandomState(5)
    centers = _unit(rng.randn(WAY, 32))
    x = _unit(np.repeat(centers, 5, 0) + 0.35 * rng.randn(WAY * 5, 32))
    xq = _unit(np.repeat(centers, 8, 0) + 0.55 * rng.randn(WAY * 8, 32))
    d2q = ((x[:, None] - xq[None, :]) ** 2).sum(-1)
    assert d2q.min(0).max() > 0.3
    return x, np.repeat(np.arange(WAY), 5), xq


CASES = {f"{shot}shot_d{d}": (lambda shot=shot, d=d: _clustered(shot, d, d))
         for shot in (1, 5) for d in (64, 1600)}
CASES["far"] = _far


def _sklearn():
    return SkGPC(kernel=C(1.0) * RBF(length_scale=0.1,
                                     length_scale_bounds=(0.1, 10.0)),
                 optimizer=None)


@pytest.mark.parametrize("case", list(CASES))
def test_matches_sklearn(case):
    x, y, xq = CASES[case]()
    want = _sklearn().fit(x, y)
    got = GaussianProcessClassifier().fit(x, y)
    binary = np.stack([e.predict_proba(xq)[:, 1]
                       for e in want.base_estimator_.estimators_])
    assert np.abs(got.binary_proba(xq) - binary).max() <= PROBA
    assert np.abs(got.predict_proba(xq) - want.predict_proba(xq)).max() \
        <= PROBA
    assert np.array_equal(got.predict(xq), want.predict(xq))
    assert np.array_equal(got.classes_, want.classes_)
    if case != "far":  # the case reaches the kernel's live range
        assert binary.max() - binary.min() > 5e-3


def test_labels_keep_their_values():
    """Labels in any order and of any values come back as themselves;
    fewer than three classes are refused (scikit-learn fits one binary
    model there, which this copy does not)."""
    x, y, xq = _clustered(5, 64, 3)
    labels = np.array([11, 7, 30, 2, 5])[y]
    want = _sklearn().fit(x, labels)
    got = GaussianProcessClassifier().fit(x, labels)
    assert np.array_equal(got.predict(xq), want.predict(xq))
    assert np.abs(got.predict_proba(xq) - want.predict_proba(xq)).max() \
        <= PROBA
    with pytest.raises(ValueError):
        GaussianProcessClassifier().fit(x[:10], y[:10])


# -- the probe's arms against the JAX probe's --------------------------------

def _episodes(shot: int, n: int = 3, px: int = 16):
    """n episodes [1, 5, shot+15, px, px, 3] uint8: each class a base
    image and small noise on it, so that a class's features cluster."""
    rng = np.random.RandomState(shot)
    out = []
    for _ in range(n):
        base = rng.randint(0, 256, (WAY, 1, px, px, 3))
        noise = rng.randint(-12, 13, (WAY, shot + QUERY, px, px, 3))
        out.append(np.clip(base + noise, 0, 255).astype(np.uint8)[None])
    return out


def _jax_arms(jm, params, x, shot):
    """JAX benchmarks/laplace_probe.py:78-103 on one episode."""
    z_all, _ = jm._features(params, flatten_episode(jnp.asarray(x)))
    d = z_all.shape[-1]
    z = np.asarray(z_all, np.float64).reshape(WAY, shot + QUERY, d)
    z_support = z[:, :shot].reshape(WAY * shot, d)
    z_query = z[:, shot:].reshape(-1, d)
    y_support = np.asarray(episode_labels(WAY, shot))
    y_query = np.asarray(episode_labels(WAY, QUERY))
    pred = np.asarray(laplace_ovr_predict(
        jnp.asarray(z_support, jnp.float32), jnp.asarray(y_support),
        jnp.asarray(z_query, jnp.float32), WAY))
    gpc = _sklearn().fit(z_support, y_support)
    gp_pred = np.asarray(jnp.argmax(jm.episode_scores(params,
                                                      jnp.asarray(x)), -1))
    g = np.asarray(rbf_gram(jnp.asarray(z_support, jnp.float32),
                            jnp.asarray(z_support, jnp.float32)))
    n = g.shape[0]
    return {"ours": float(np.mean(pred == y_query)) * 100.0,
            "sklearn": float(np.mean(gpc.predict(z_query) == y_query))
            * 100.0,
            "gp": float(np.mean(gp_pred == y_query)) * 100.0,
            "offdiag": float((g.sum() - np.trace(g)) / (n * n - n))}


@pytest.mark.parametrize("shot", [1, 5])
def test_probe_rows_match_the_jax_probe(shot, monkeypatch):
    episodes = _episodes(shot)
    jm = JDKT(jbb.ConvNetS(depth=2), WAY, shot, "bncossim",
              feature_dtype="float32")
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(episodes[0][0])).params)
    tm = DKT(ConvNet(2, first_channel=True), WAY, shot, "bncossim",
             feature_dtype="float32", device="cpu").init(
                 torch.from_numpy(episodes[0][0]))
    dkt_params_from_jax(params, tm, 16)
    want = [_jax_arms(jm, params, xb[0], shot) for xb in episodes]
    got = [laplace_probe.episode_arms(tm, torch.from_numpy(xb[0]), shot)
           for xb in episodes]
    for g, w in zip(got, want):
        for arm in ("ours", "sklearn", "gp"):
            assert g[arm] == w[arm], (arm, g, w)
        n = WAY * shot
        assert abs(g["offdiag"] - w["offdiag"]) <= 1e-5 * w["offdiag"] \
            + 8 * np.spacing(np.float32(n)) / (n * n - n)
    assert max(w["sklearn"] for w in want) > 20.0  # not the collapsed head
    rows = laplace_probe.probe_rows(tm, episodes, shot)
    pre = f"digits_real_laplace_probe_{shot}shot"
    assert set(rows) == {k for k in laplace_probe.JAX_ROWS
                         if k.startswith(pre)} | {f"{pre}_sklearn_float64"}
    assert rows[f"{pre}_sklearn_float64"] is True
    for arm in ("ours", "sklearn", "gp"):
        acc, ci = laplace_probe.mean_ci([w[arm] for w in want])
        assert rows[f"{pre}_{arm}_acc"] == acc
        assert rows[f"{pre}_{arm}_ci95"] == ci
