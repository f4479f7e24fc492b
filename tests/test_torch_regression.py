"""The port's regression track (deep_kernel_transfer_tpu_torch: Conv3, MLP2,
the spectral-mixture kernel, DKTRegression, FeatureTransfer, the sines
MAML, the QMUL and sines loaders) against the JAX package's, on the same
numpy inputs, with the JAX weights carried over by utils/convert.py.

Tolerances: forward 1e-5 absolute (a spectral Gram: 1e-5 of its diagonal,
because products of thousands of cosines reach the denormal range, which
XLA's CPU flushes to zero and torch does not); gradients 2e-2 of each
gradient's largest entry (ROADMAP's rule); losses over 5 training steps
1e-4 relative and parameters 1e-3 of each tensor's largest entry.

The JAX package takes the spectral kernel's exp term through sq_dist,
|a|^2 + |b|^2 - 2 a.b, whose f32 cancellation at the features' norms
(|z|^2 of 1e2 on sines, 1e4 on a trained Conv3) moves the Gram by 1e-3 to
1e-1 of its diagonal against float64; the port sums the differences
elementwise, as gpytorch does. The spectral comparisons therefore run the
JAX kernel with its sq_dist replaced by that exact sum (the
`exact_jax_sq_dist` fixture; nothing in the JAX package changes), and
the port alone is held to float64 at a trained Conv3's norms.

The DKT comparisons on Conv3 take images scaled by 0.02 (Conv3 has no
biases at init and is positively homogeneous, so the features scale with
the images): on [0, 1] images the Gram is diagonal to 1e-9, the trunk's
true gradient is of that size, and f32 rounding of the diagonal's
distance, in either package, is larger.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu.data import qmul as jqmul
from deep_kernel_transfer_tpu.data import sines as jsines
from deep_kernel_transfer_tpu.gp import kernels as jkernels
from deep_kernel_transfer_tpu.methods import DKTRegression as JDKTR
from deep_kernel_transfer_tpu.methods import FeatureTransfer as JFT
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu_torch.data import qmul as tqmul
from deep_kernel_transfer_tpu_torch.data import sines as tsines
from deep_kernel_transfer_tpu_torch.gp import kernels as tkernels
from deep_kernel_transfer_tpu_torch.methods import DKTRegression, FeatureTransfer
from deep_kernel_transfer_tpu_torch.models import backbones as tbb
from deep_kernel_transfer_tpu_torch.sines import common as tcommon
from deep_kernel_transfer_tpu_torch.sines.train_MAML import SinesMAML
from deep_kernel_transfer_tpu_torch.utils.convert import (
    backbone_state_from_jax, flatten_perm, params_from_jax)
from sines_tpu import common as jcommon
from sines_tpu import train_MAML as jmaml
from torch_test_threads import one_thread  # noqa: F401

SHRINK = 0.02  # image scale of the DKT comparisons on Conv3 (above)


def _exact_sq_dist(x1, x2):
    return jnp.sum(jnp.square(x1[:, None, :] - x2[None, :, :]), axis=-1)


@pytest.fixture
def exact_jax_sq_dist(monkeypatch):
    """The JAX kernels' sq_dist as the exact elementwise sum (see above)."""
    monkeypatch.setattr(jkernels, "sq_dist", _exact_sq_dist)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _t(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), requires_grad=grad)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _images(n, px, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, px, px, 3) * scale).astype(np.float32)


def _spectral_params(q, d, seed=0):
    rng = np.random.RandomState(seed)
    return {"raw_weights": rng.uniform(-0.5, 0.5, q).astype(np.float32),
            "raw_means": rng.randn(q, d).astype(np.float32),
            "raw_scales": rng.randn(q, d).astype(np.float32)}


# -- kernels ------------------------------------------------------------------


@pytest.mark.parametrize("d", [5, 40])
def test_spectral_gram_and_grads_match_jax(d, exact_jax_sq_dist):
    p = _spectral_params(4, d, seed=d)
    rng = np.random.RandomState(1)
    x1 = (rng.randn(7, d) * 0.1 / np.sqrt(d)).astype(np.float32)
    x2 = (rng.randn(5, d) * 0.1 / np.sqrt(d)).astype(np.float32)
    r = rng.randn(7, 5).astype(np.float32)
    jk = jkernels.make_kernel("spectral", dim=d)
    tk = tkernels.make_kernel("spectral", dim=d)

    def jloss(p, a, b):
        return jnp.sum(jk.apply(p, a, b) * r)

    want = np.asarray(jk.apply(p, x1, x2))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(p, x1, x2)
    tp, ta, tb = _t(p, True), torch.tensor(x1, requires_grad=True), \
        torch.tensor(x2, requires_grad=True)
    got = tk.apply(tp, ta, tb)
    scale = float(np.sum(np.log1p(np.exp(p["raw_weights"]))))
    assert np.abs(got.detach().numpy() - want).max() < 1e-5 * scale
    assert np.abs(want).max() > 1e-2 * scale  # off-diagonal mass
    (got * torch.from_numpy(r)).sum().backward()
    for k in p:
        assert _rel(tp[k].grad, jg[0][k]) < 2e-2, k
    assert _rel(ta.grad, jg[1]) < 2e-2 and _rel(tb.grad, jg[2]) < 2e-2


def test_spectral_diag_is_sum_of_weights(exact_jax_sq_dist):
    p = _spectral_params(4, 40)
    x = torch.from_numpy(np.random.RandomState(2).randn(6, 40)
                         .astype(np.float32))
    tk = tkernels.make_kernel("spectral", dim=40)
    gram = tk.apply(_t(p), x, x)
    diag = tk.diag(_t(p), x)
    want = np.sum(np.log1p(np.exp(p["raw_weights"].astype(np.float64))))
    assert diag.shape == (6,)
    assert np.allclose(diag.numpy(), want, atol=1e-6)
    assert np.allclose(torch.diagonal(gram).numpy(), want, atol=1e-6)
    jk = jkernels.make_kernel("spectral", dim=40)
    jdiag = [float(jk.apply(p, r[None], r[None])[0, 0]) for r in x.numpy()]
    assert np.allclose(jdiag, want, atol=1e-6)


def test_product_backward_near_zero():
    """The spectral kernel's product of cosines and its backward against
    jnp.prod's, with a near-zero factor, an exact zero and a product that
    underflows, at D = 2916; no division by a factor."""
    rng = np.random.RandomState(3)
    x = (rng.uniform(0.5, 1.5, (4, 2916))
         * np.sign(rng.randn(4, 2916))).astype(np.float32)
    x[:, :2900] = np.cos(rng.uniform(-0.05, 0.05, (4, 2900))).astype(
        np.float32)
    x[1, 7] = 1e-30
    x[2, 11] = 0.0
    x[3] *= 0.5  # underflows to 0
    g = rng.randn(4).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.prod(a, -1) * g))(
        jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    out = tkernels._Prod.apply(t)
    assert np.allclose(out.detach().numpy(), np.prod(x, -1), rtol=1e-4,
                       atol=1e-38)
    (out * torch.from_numpy(g)).sum().backward()
    assert torch.isfinite(t.grad).all()
    for row in range(4):
        assert _rel(t.grad[row], want[row]) < 2e-2 or (
            np.abs(want[row]).max() < 1e-30
            and float(t.grad[row].abs().max()) < 1e-30), row


def _conv3_pair(px, seed=0):
    jm = jbb.Conv3()
    fvars = _np(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, px, px, 3))))
    tm = tbb.Conv3()
    tm.load_state_dict({k: torch.tensor(v) for k, v in
                        backbone_state_from_jax(fvars, tm, "").items()})
    return jm, fvars, tm


@pytest.mark.parametrize("px", [40, 100])
def test_conv3_matches_jax(px):
    jm, fvars, tm = _conv3_pair(px)
    assert tm.out_dim(px, px) == (2916 if px == 100 else 144)
    perm = flatten_perm(tm, px)
    x = _images(4, px)
    want = np.asarray(jm.apply(fvars, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (4, tm.out_dim(px, px))
    assert np.abs(got[:, perm] - want).max() < 1e-5 * max(
        np.abs(want).max(), 1.0)
    u8 = (x * 255).astype(np.uint8)  # uint8 scales by 1/255 only
    want8 = np.asarray(jm.apply(fvars, jnp.asarray(u8)))
    got8 = tm(torch.from_numpy(u8)).detach().numpy()
    assert np.abs(got8[:, perm] - want8).max() < 1e-5 * max(
        np.abs(want8).max(), 1.0)
    # gradients in every weight
    r = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jm.apply(v, jnp.asarray(x)) * r))(fvars)
    tm.zero_grad()
    (tm(torch.from_numpy(x)) * torch.from_numpy(r[:, np.argsort(perm)])
     ).sum().backward()
    want_g = backbone_state_from_jax(_np(jg), tm, "")
    for name, p in tm.named_parameters():
        assert _rel(p.grad, want_g[name]) < 2e-2, name


def test_mlp2_matches_jax():
    jm = jbb.MLP2()
    fvars = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1))))
    tm = tbb.MLP2()
    tm.load_state_dict({k: torch.tensor(v) for k, v in
                        backbone_state_from_jax(fvars, tm, "").items()})
    x = np.linspace(-5, 5, 11, dtype=np.float32)[:, None]
    want = np.asarray(jm.apply(fvars, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (11, 40) and np.abs(got - want).max() < 1e-5
    # init laws: lecun_normal (truncated at 2 std) and zero biases
    fresh = tbb.MLP2()
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    w = fresh.layer2.weight.detach().numpy()
    std = np.sqrt(1 / 40) / .87962566103423978
    assert np.abs(w).max() <= 2 * std + 1e-6
    assert float(fresh.layer2.bias.detach().abs().max()) == 0.0


def test_spectral_2916_through_converter(exact_jax_sq_dist):
    """DKTRegression(Conv3, spectral) carried over from the JAX package: the
    ARD means and scales [4, 2916] permuted from HWC to CHW order give the
    JAX Gram; with the permutation left out they do not."""
    jm = JDKTR(jbb.Conv3(), feat_dim=2916, kernel_type="spectral")
    x = _images(6, 100, scale=SHRINK)
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)).params)
    tm = DKTRegression(tbb.Conv3(), 2916, "spectral", device="cpu").init()
    params_from_jax(params, tm, 100)
    z_j = np.asarray(jm._features(params, jnp.asarray(x)))
    want = np.asarray(jm.gp.kernel.apply(params["gp"]["kernel"], z_j, z_j))
    with torch.no_grad():
        z_t = tm._features(torch.from_numpy(x))
        got = tm.spec.kernel.apply(tm.gp.tree()["kernel"], z_t, z_t).numpy()
    diag = float(np.max(np.diag(want)))
    assert np.abs(got - want).max() < 1e-5 * diag
    off = ~np.eye(6, dtype=bool)
    assert np.abs(want[off]).max() > 1e-2 * diag  # the test has teeth
    unpermuted = {k: torch.tensor(v) for k, v in
                  params["gp"]["kernel"].items()}
    with torch.no_grad():
        wrong = tm.spec.kernel.apply(unpermuted, z_t, z_t).numpy()
    assert np.abs(wrong - want).max() > 1e-3 * diag
    # gradients in the kernel's parameters and the features, within 2e-2
    r = np.random.RandomState(2).randn(6, 6).astype(np.float32)
    jg = jax.grad(lambda p, z: jnp.sum(jm.gp.kernel.apply(p, z, z) * r),
                  argnums=(0, 1))(params["gp"]["kernel"], jnp.asarray(z_j))
    kp = {k: v.detach().clone().requires_grad_(True)
          for k, v in tm.gp.tree()["kernel"].items()}
    zt = z_t.clone().requires_grad_(True)
    (tm.spec.kernel.apply(kp, zt, zt) * torch.from_numpy(r)).sum().backward()
    rows = np.argsort(flatten_perm(tm.feature, 100))
    assert _rel(kp["raw_weights"].grad, jg[0]["raw_weights"]) < 2e-2
    for k in ("raw_means", "raw_scales"):
        assert _rel(kp[k].grad, np.asarray(jg[0][k])[:, rows]) < 2e-2, k
    assert _rel(zt.grad, np.asarray(jg[1])[:, rows]) < 2e-2


def test_spectral_f32_holds_float64_at_conv3_norms():
    """At a trained Conv3's feature norms (|z|^2 near 1e4, as after 2
    epochs on the synthetic QMUL grid; images scaled by 12 here) the
    port's f32 Gram stays within 1e-5 of its diagonal of the float64
    one."""
    _, _, trunk = _conv3_pair(100)
    with torch.no_grad():
        z = trunk(torch.from_numpy(_images(8, 100, scale=12.0)))
    assert float((z * z).sum(-1).min()) > 1e3
    p = _t(_spectral_params(4, 2916))
    k = tkernels.make_kernel("spectral", dim=2916)
    got = k.apply(p, z, z)
    want = k.apply({n: v.double() for n, v in p.items()}, z.double(),
                   z.double())
    assert float((got - want).abs().max()) < 1e-5 * float(want.max())


@pytest.mark.parametrize("n", [19, 1])
def test_initialize_spectral_from_data(n):
    """The data-driven init against the JAX one on the same draws (the
    port draws from a torch.Generator), a one-point task included."""
    rng = np.random.RandomState(n)
    x = rng.randn(n, 40).astype(np.float32)
    x[:, 3] = 0.5  # a constant dimension: no positive gap
    y = rng.randn(n).astype(np.float32)
    p = _spectral_params(4, 40)
    key = jax.random.PRNGKey(7)
    want = _np(jkernels.initialize_spectral_from_data(p, jnp.asarray(x),
                                                      jnp.asarray(y), key))
    k1, k2 = jax.random.split(key)
    u = torch.tensor(np.asarray(jax.random.uniform(k1, (4, 40))))
    g = torch.tensor(np.asarray(jax.random.normal(k2, (4, 40))))
    got = tkernels.spectral_init_from_draws(torch.from_numpy(x),
                                            torch.from_numpy(y), u, g)
    for key_ in want:
        assert np.allclose(got[key_].numpy(), want[key_], rtol=1e-5,
                           atol=1e-5), key_
    mine = tkernels.initialize_spectral_from_data(
        _t(p), torch.from_numpy(x), torch.from_numpy(y),
        torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v).all()) for v in mine.values())
    assert mine["raw_means"].shape == (4, 40)


# -- DKTRegression ---------------------------------------------------------


def _dkt_pair(kind, trunk="Conv3", px=100, seed=0):
    feat = {"Conv3": tbb.Conv3().out_dim(px, px), "MLP2": 40}[trunk]
    jm = JDKTR(getattr(jbb, trunk)(), feat_dim=feat, kernel_type=kind)
    example = (jnp.zeros((19, px, px, 3)) if trunk == "Conv3"
               else jnp.zeros((10, 1)))
    state = jm.init(jax.random.PRNGKey(seed), example)
    tm = DKTRegression(getattr(tbb, trunk)(), feat, kind,
                       device="cpu").init()
    params_from_jax(_np(state.params), tm, px)
    return jm, state, tm


def _port_params(tm) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tm.state_dict().items()}


@pytest.mark.parametrize("kind", ["rbf", "spectral"])
def test_dkt_regression_task_loss_and_grads(kind, exact_jax_sq_dist):
    jm, state, tm = _dkt_pair(kind)
    x = _images(19, 100, seed=4, scale=SHRINK)
    y = np.random.RandomState(5).uniform(-1, 1, 19).astype(np.float32)
    jl, jg = jax.value_and_grad(jm.task_loss)(state.params, jnp.asarray(x),
                                              jnp.asarray(y))
    loss = tm.task_loss(torch.from_numpy(x), torch.from_numpy(y))
    assert abs(loss.item() - float(jl)) < 1e-4 * abs(float(jl))
    loss.backward()
    want = params_from_jax_state(_np(jg), tm)
    for name, p in tm.named_parameters():
        assert _rel(p.grad, want[name]) < 2e-2, name


def params_from_jax_state(tree, tm, px=100):
    from deep_kernel_transfer_tpu_torch.utils.convert import state_from_jax

    return state_from_jax(tree, tm, px)


def _sines_batches(steps, b, n=10, seed=0):
    rng = np.random.RandomState(seed)
    tasks = jsines.TaskDistribution()
    return [tasks.sample_batch(rng, b, n) for _ in range(steps)]


def _qmul_batches(steps, b, px=40, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [((rng.rand(b, 8, px, px, 3) * scale).astype(np.float32),
             rng.uniform(-1, 1, (b, 8)).astype(np.float32))
            for _ in range(steps)]


def _run_steps(jm, state, tm, batches, mode, dtype):
    """The same train steps in both packages; returns the JAX state and
    the losses' largest relative difference."""
    jstep = getattr(jm, "unbatched_train_step" if mode == "unbatched"
                    else "train_step")
    tstep = getattr(tm, "unbatched_train_step" if mode == "unbatched"
                    else "train_step")
    worst = 0.0
    for xb, yb in batches:
        xb, yb = xb.astype(dtype), yb.astype(dtype)
        state, jmet = jstep(state, jnp.asarray(xb), jnp.asarray(yb))
        tmet = tstep(torch.from_numpy(xb), torch.from_numpy(yb))
        worst = max(worst, abs(float(tmet["loss"]) - float(jmet["loss"]))
                    / abs(float(jmet["loss"])))
        assert abs(float(tmet["noise"]) - float(jmet["noise"])) < 1e-5
    return state, worst


@pytest.mark.parametrize("case", ["conv3_rbf", "mlp2_spectral"])
@pytest.mark.parametrize("mode", ["unbatched", "batched"])
def test_dkt_regression_train_steps_match_jax(case, mode, exact_jax_sq_dist):
    """5 steps of unbatched_train_step (one Adam step a task, in order) or
    train_step (one on the tasks' mean) on the same batches: in f32 the
    losses within 1e-4 relative; the parameters after the steps, with both
    packages in float64, within 1e-3 of each tensor's largest entry or of
    the learning rate. In f32 the parameters cannot be held so: a
    stationary kernel sees only differences of features, so the gradient
    of MLP2's last bias is zero in exact arithmetic, rounding leaves 1e-8
    of either sign, and Adam's first step turns that into up to half the
    learning rate in either package (measured: 1e-17 in float64)."""
    def pair():
        if case == "conv3_rbf":
            return _dkt_pair("rbf", px=40)
        return _dkt_pair("spectral", trunk="MLP2")

    batches = (_qmul_batches(5, 3, scale=SHRINK) if case == "conv3_rbf"
               else _sines_batches(5, 3))
    jm, state, tm = pair()
    _, worst = _run_steps(jm, state, tm, batches, mode, np.float32)
    assert worst < 1e-4
    jm, state, tm = pair()
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                           state.params)
        state = state._replace(params=p64, opt_state=jm.tx.init(p64))
        tm.double()
        state, worst = _run_steps(jm, state, tm, batches, mode, np.float64)
        steps = int(state.step)
    assert worst < 1e-10
    assert tm.step == steps == (15 if mode == "unbatched" else 5)
    want = params_from_jax_state(_np(state.params), tm, 40)
    for name, value in _port_params(tm).items():
        err = np.abs(value - want[name]).max()
        assert err < 1e-3 * max(np.abs(want[name]).max(), tm.lr), name


def test_predict_confidence_region_and_samples(exact_jax_sq_dist):
    jm, state, tm = _dkt_pair("spectral", trunk="MLP2")
    rng = np.random.RandomState(3)
    _, xs, ys, xq, yq, _, _ = jcommon.sample_eval_task(
        rng, jcommon.test_tasks(False))
    want = jm.predict(state.params, jnp.asarray(xs), jnp.asarray(ys),
                      jnp.asarray(xq))
    got = tm.predict(torch.from_numpy(xs), torch.from_numpy(ys),
                     torch.from_numpy(xq))
    # 1e-5 of the largest mean (up to 5) and variance (about 3)
    big = max(1.0, float(got.mean.abs().max()))
    assert np.abs(got.mean.numpy() - np.asarray(want.mean)).max() < 1e-5 * big
    assert np.abs(got.variance.numpy() - np.asarray(want.variance)).max() \
        < 1e-5 * max(1.0, float(got.variance.max()))
    lo, hi = got.confidence_region()
    jlo, jhi = want.confidence_region()
    assert np.abs(lo.numpy() - np.asarray(jlo)).max() < 1e-5 * big
    assert np.abs(hi.numpy() - np.asarray(jhi)).max() < 1e-5 * big
    mse = tm.test_mse(*(torch.from_numpy(a) for a in (xs, ys, xq, yq)))
    assert abs(mse - jm.test_mse(state.params, xs, ys, xq, yq)) < 1e-5

    # samples through the covariance's jittered Cholesky: mean and
    # covariance over 40000 draws within 5 standard errors
    full = tm.predict(torch.from_numpy(xs), torch.from_numpy(ys),
                      torch.from_numpy(xq[:6]), full_covariance=True)
    assert np.allclose(torch.diagonal(full.covariance).numpy(),
                       full.variance.numpy(), atol=1e-6)
    draws = full.sample(40000, torch.Generator().manual_seed(0)).double()
    assert draws.shape == (40000, 6)
    sd = full.stddev.double()
    assert bool(((draws.mean(0) - full.mean.double()).abs()
                 < 5 * sd / 200).all())
    cov = torch.cov(draws.T)
    scale = torch.outer(sd, sd)
    assert bool(((cov - full.covariance.double()).abs()
                 < 5 * np.sqrt(2) * scale / 200).all())
    marg = got.sample(40000, torch.Generator().manual_seed(1)).double()
    assert bool(((marg.std(0) - got.stddev.double()).abs()
                 < 5 * got.stddev.double() / 200).all())


def test_init_spectral_from_data_resets_the_optimizer():
    _, _, tm = _dkt_pair("spectral", trunk="MLP2")
    xb, yb = _sines_batches(1, 2)[0]
    tm.train_step(torch.from_numpy(xb), torch.from_numpy(yb))
    before = tm.gp.kernel.raw_means.detach().clone()
    tm.init_spectral_from_data(torch.from_numpy(xb[0]),
                               torch.from_numpy(yb[0]),
                               torch.Generator().manual_seed(0))
    assert not torch.equal(before, tm.gp.kernel.raw_means)
    assert tm.step == 1 and not tm.optimizer.state  # JAX keeps its step


# -- FeatureTransfer ----------------------------------------------------------


def _ft_pair(trunk="Conv3", px=40, seed=0):
    jm = JFT(getattr(jbb, trunk)())
    example = (jnp.zeros((8, px, px, 3)) if trunk == "Conv3"
               else jnp.zeros((10, 1)))
    state = jm.init(jax.random.PRNGKey(seed), example)
    tm = FeatureTransfer(getattr(tbb, trunk)(), device="cpu").init(
        torch.from_numpy(np.asarray(example)))
    params_from_jax(_np(state.params), tm, px)
    return jm, state, tm


def test_feature_transfer_train_steps_match_jax():
    jm, state, tm = _ft_pair()
    for xb, yb in _qmul_batches(5, 3, seed=1):
        state, jmet = jm.train_step(state, jnp.asarray(xb), jnp.asarray(yb))
        tmet = tm.train_step(torch.from_numpy(xb), torch.from_numpy(yb))
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) < 1e-4 * abs(
            float(jmet["loss"]))
    want = params_from_jax_state(_np(state.params), tm, 40)
    for name, value in _port_params(tm).items():
        assert _rel(value, want[name]) < 1e-3, name


def test_feature_transfer_adapt_and_predict():
    """One Adam step from a fresh state on the support: the gradient before
    the step within 2e-2, the predictions within 1e-4 of their largest."""
    jm, state, tm = _ft_pair()
    x = _images(8, 40, seed=6)
    y = np.random.RandomState(6).uniform(-1, 1, 8).astype(np.float32)
    xs, ys = x[:5], y[:5]
    jg = jax.grad(jm.task_loss)(state.params, jnp.asarray(xs),
                                jnp.asarray(ys))
    got_g = tm._support_grads(tm._params(), torch.from_numpy(xs),
                              torch.from_numpy(ys))
    want_g = params_from_jax_state(_np(jg), tm, 40)
    for name, g in got_g.items():
        assert _rel(g, want_g[name]) < 2e-2, name
    want = np.asarray(jm.adapt_and_predict(state, jnp.asarray(xs),
                                           jnp.asarray(ys), jnp.asarray(x)))
    got = tm.adapt_and_predict(torch.from_numpy(xs), torch.from_numpy(ys),
                               torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    mse = tm.test_mse(*(torch.from_numpy(a) for a in (xs, ys, x, y)))
    assert abs(mse - jm.test_mse(state, xs, ys, x, y)) < 1e-4 * mse


def test_feature_transfer_finetune_and_predict():
    """100 steps of a fresh Adam(1e-2) on a sines support, MLP2: the
    predictions within 1e-3 of their largest."""
    jm, state, tm = _ft_pair("MLP2")
    rng = np.random.RandomState(4)
    _, xs, ys, xq, _, _, _ = jcommon.sample_eval_task(
        rng, jcommon.test_tasks(False))
    want = np.asarray(jm.finetune_and_predict(
        state.params, (jnp.asarray(xs), jnp.asarray(ys)), jnp.asarray(xq),
        steps=100, lr=1e-2))
    got = tm.finetune_and_predict((torch.from_numpy(xs),
                                   torch.from_numpy(ys)),
                                  torch.from_numpy(xq)).numpy()
    assert np.abs(got - want).max() < 1e-3 * np.abs(want).max()
    before = _port_params(tm)  # the model itself is untouched
    tm.finetune_and_predict((torch.from_numpy(xs), torch.from_numpy(ys)),
                            torch.from_numpy(xq), steps=3)
    assert all(np.array_equal(v, before[k])
               for k, v in _port_params(tm).items())


# -- sines MAML -----------------------------------------------------------


def _maml_pair():
    jm = jmaml.SinesMAML(meta_batch=4)
    params, opt = jm.init(jax.random.PRNGKey(0))
    tm = SinesMAML(meta_batch=4, device="cpu").init()
    params_from_jax(_np(params), tm, None)
    return jm, params, opt, tm


def test_sines_maml_meta_steps_match_jax():
    """3 second-order meta steps: losses 1e-4 relative, weights 1e-3."""
    jm, params, opt, tm = _maml_pair()
    for xb, yb in _sines_batches(3, 4, seed=2):
        params, opt, jl = jm.meta_step(params, opt, jnp.asarray(xb),
                                       jnp.asarray(yb))
        tl = tm.meta_step(torch.from_numpy(xb), torch.from_numpy(yb))
        assert abs(float(tl) - float(jl)) < 1e-4 * abs(float(jl))
    want = params_from_jax_state(_np(params), tm, None)
    for name, value in _port_params(tm).items():
        assert _rel(value, want[name]) < 1e-3, name


def test_sines_maml_adaptation_matches_jax():
    jm, params, _, tm = _maml_pair()
    rng = np.random.RandomState(5)
    _, xs, ys, xq, yq, _, _ = jcommon.sample_eval_task(
        rng, jcommon.test_tasks(False))
    support = (jnp.asarray(xs), jnp.asarray(ys))
    tsupport = (torch.from_numpy(xs), torch.from_numpy(ys))
    jmse, jpred = jm.adapt_trajectory(params, support, jnp.asarray(xq),
                                      jnp.asarray(yq), n_steps=6)
    tmse, tpred = tm.adapt_trajectory(tsupport, torch.from_numpy(xq),
                                      torch.from_numpy(yq), n_steps=6)
    assert tmse.shape == (7,) and tpred.shape == (7, len(xq))
    assert _rel(tmse, jmse) < 1e-4
    assert np.abs(tpred.numpy() - np.asarray(jpred)).max() < 1e-4
    want = np.asarray(jm.adapt_predict(params, support, jnp.asarray(xq),
                                       n_steps=10))
    got = tm.adapt_predict(tsupport, torch.from_numpy(xq), n_steps=10)
    assert np.abs(got.numpy() - want).max() < 1e-4 * np.abs(want).max()


# -- data ---------------------------------------------------------------------


PEOPLE = ["AliceGrey", "BobGrey"]


@pytest.fixture(scope="module")
def qmul_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("qmul")
    rng = np.random.RandomState(0)
    for person in PEOPLE:
        d = root / person
        d.mkdir(parents=True)
        for pitch in range(60, 130, 10):
            for angle in range(0, 190, 10):
                arr = np.full((40, 40, 3), int(pitch * 255 / 120), np.uint8)
                arr += (rng.rand(40, 40, 3) * 20).astype(np.uint8)
                Image.fromarray(arr).save(
                    tqmul.face_file(str(root), person, pitch, angle))
    return str(root) + "/"


def test_qmul_get_batch_matches_jax(qmul_dir):
    for seed in range(3):
        got = tqmul.get_batch(PEOPLE, np.random.RandomState(seed),
                              prefix=qmul_dir)
        want = jqmul.get_batch(PEOPLE, np.random.RandomState(seed),
                               prefix=qmul_dir)
        assert got[0].dtype == np.float32 and got[0].shape == (2, 19, 40,
                                                               40, 3)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    rng = np.random.RandomState(9)
    assert tqmul.sample_trajectory(rng) == jqmul.sample_trajectory(
        np.random.RandomState(9))
    assert tqmul.train_people == jqmul.train_people
    assert tqmul.test_people == jqmul.test_people
    assert [tqmul.num_to_str(n) for n in (0, 10, 90, 120)] == [
        jqmul._num_to_str(n) for n in (0, 10, 90, 120)]


def test_sines_draws_bit_equal():
    for dist in (tsines.TaskDistribution(), tsines.TaskDistribution(
            family="cosine", x_max=10.0)):
        jdist = jsines.TaskDistribution(*dist)
        got = dist.sample_batch(np.random.RandomState(4), 5, 10, noise=0.1)
        want = jdist.sample_batch(np.random.RandomState(4), 5, 10, noise=0.1)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    got = tcommon.sample_eval_task(np.random.RandomState(2),
                                   tcommon.test_tasks(True))
    want = jcommon.sample_eval_task(np.random.RandomState(2),
                                    jcommon.test_tasks(True))
    assert tuple(got[0]) == tuple(want[0])
    assert all(np.array_equal(a, b) for a, b in zip(got[1:], want[1:]))
    assert (tcommon.N_SHOT_TRAIN, tcommon.N_SHOT_TEST, tcommon.SAMPLE_SIZE) \
        == (jcommon.N_SHOT_TRAIN, jcommon.N_SHOT_TEST, jcommon.SAMPLE_SIZE)
