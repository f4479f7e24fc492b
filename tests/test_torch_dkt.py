"""The port's DKT (deep_kernel_transfer_tpu_torch/methods/dkt.py) against
the JAX package's DKT: one training step and the eval head, on the same
weights (carried across with utils.convert.dkt_params_from_jax) and the
same episodes.

ConvNet(depth=2) at 16 px, 5-way 2-shot 3-query, 2 episodes, float32
trunk. The port's fused route (use_fused_mll=True; on CPU tensors the
kernel's plain version) is held to the JAX package's Pallas route run in
interpret mode, the plain route to the JAX plain route.

Tolerances: loss 1e-4 relative; gradients 2e-2 of each leaf's largest
entry, that scale floored at 1e-4, because some leaves have an exact
gradient of zero and hold only rounding noise (each conv bias feeds a
train-mode BatchNorm, which removes any per-channel constant; the last
block's BatchNorm scale is normalised away by bn_out while the shift is
zero); updated parameters 2*lr + 1e-6, since Adam's first step is about
lr*sign(g) and a gradient near zero may flip sign; running statistics 1e-5.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu_torch.methods import DKT
from deep_kernel_transfer_tpu_torch.models import ConvNet
from deep_kernel_transfer_tpu_torch.utils.convert import (
    dkt_params_from_jax, dkt_state_from_jax)

B, WAY, SHOT, QUERY, PX = 2, 5, 2, 3, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _episodes(seed=0, b=B, query=QUERY):
    return np.random.RandomState(seed).randint(
        0, 256, (b, WAY, SHOT + query, PX, PX, 3)).astype(np.uint8)


def _pair(fused, dtype="float32"):
    x = _episodes()
    jm = JDKT(jbb.ConvNet(depth=2), WAY, SHOT, "bncossim",
              feature_dtype=dtype, use_pallas_mll=fused)
    state = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    tm = DKT(ConvNet(2), WAY, SHOT, "bncossim", feature_dtype=dtype,
             use_fused_mll=fused, device="cpu").init(torch.from_numpy(x[0]))
    dkt_params_from_jax(jax.tree.map(np.asarray, state.params), tm, PX)
    return x, jm, state, tm


@pytest.fixture(scope="module", params=[True, False], ids=["fused", "plain"])
def step(request):
    """The eval head on the converted weights, one train step on both
    sides, then batch_correct on the new weights."""
    fused = request.param
    x, jm, state, tm = _pair(fused)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            jm.batch_loss_train, has_aux=True))(state.params, jnp.asarray(x))
        jstate, _ = jm.train_step(state, jnp.asarray(x))
    jacc = np.asarray(jm.batch_correct(jstate.params, jnp.asarray(x)))
    # the eval head on the weights before the step
    jlogits = np.asarray(jm.batch_logits(state.params, jnp.asarray(x)))
    jall = np.asarray(jm.episode_logits(state.params, jnp.asarray(x[1]),
                                        condition_on_all=True))
    jcorrect = jm.correct(state.params, jnp.asarray(x[0]))
    with torch.no_grad():
        tlogits = tm.batch_logits(torch.from_numpy(x)).numpy()
        tall = tm.episode_logits(torch.from_numpy(x[1]),
                                 condition_on_all=True).numpy()
    tcorrect = tm.correct(torch.from_numpy(x[0]))
    metrics = tm.train_step(torch.from_numpy(x))
    tacc = tm.batch_correct(torch.from_numpy(x)).numpy()
    jgrads = jax.tree.map(np.asarray, jgrads)
    return dict(
        jlogits=jlogits, tlogits=tlogits, jall=jall, tall=tall,
        jcorrect=jcorrect, tcorrect=tcorrect,
        tm=tm, jloss=float(jloss), tloss=float(metrics["loss"]),
        jgrads=dkt_state_from_jax({"feature": {"params":
                                               jgrads["feature"]["params"]},
                                   "gp": jgrads["gp"]}, tm, PX),
        jparams=dkt_state_from_jax(jax.tree.map(np.asarray, jstate.params),
                                   tm, PX),
        jacc=jacc, tacc=tacc, metrics=metrics)


def test_loss_matches_jax(step):
    assert abs(step["tloss"] - step["jloss"]) < 1e-4 * abs(step["jloss"])


def test_gradients_match_jax(step):
    named = dict(step["tm"].named_parameters())
    assert set(named) == set(step["jgrads"])
    for name, want in step["jgrads"].items():
        got = named[name].grad.numpy()
        scale = max(np.abs(want).max(), 1e-4)
        assert np.abs(got - want).max() < 2e-2 * scale, name


def test_updated_params_match_jax(step):
    tm = step["tm"]
    state = tm.state_dict()
    lrs = {n: tm.gp_lr if n.startswith("gp.") else tm.feature_lr
           for n, _ in tm.named_parameters()}
    for name, lr in lrs.items():
        diff = np.abs(state[name].numpy() - step["jparams"][name]).max()
        assert diff < 2 * lr + 1e-6, name


def test_running_stats_match_jax(step):
    state = step["tm"].state_dict()
    running = [k for k in step["jparams"] if "running" in k]
    assert len(running) == 6
    for name in running:
        assert np.abs(state[name].numpy()
                      - step["jparams"][name]).max() < 1e-5, name


def test_batch_correct_matches_jax(step):
    assert step["tacc"].shape == (B,)
    assert np.array_equal(step["tacc"], step["jacc"])


def test_logits_match_jax(step):
    """Posterior means at the queries, GP on the support set, eval-mode
    BatchNorm, on the weights before the step (after it, Adam's sign flips
    on zero-gradient leaves such as the conv biases, which eval-mode
    BatchNorm does not cancel, move them by up to about 1e-3); 1e-4
    absolute, since the f32 trunk and solves round differently."""
    assert step["tlogits"].shape == step["jlogits"].shape == (
        B, WAY * QUERY, WAY)
    assert np.abs(step["tlogits"] - step["jlogits"]).max() < 1e-4


def test_logits_conditioned_on_all_match_jax(step):
    assert step["tall"].shape == (WAY * QUERY, WAY)
    assert np.abs(step["tall"] - step["jall"]).max() < 1e-4


def test_correct_matches_jax(step):
    assert step["tcorrect"] == step["jcorrect"]


def test_train_step_metrics(step):
    m = step["metrics"]
    assert set(m) == {"loss", "outputscale", "noise"}
    assert abs(float(m["noise"]) - 0.1) < 1e-7
    assert abs(float(m["outputscale"]) - np.log(2.0)) < 1e-3  # one gp_lr step


def test_bf16_trunk_loss_matches_jax():
    """bf16 trunk: 5e-2 relative, because the two frameworks round to bf16
    at different places (convolution outputs, bias adds)."""
    x, jm, state, tm = _pair(fused=False, dtype="bfloat16")
    want = float(jm.batch_loss(state.params, jnp.asarray(x)))
    got, _ = tm.batch_loss_train(torch.from_numpy(x))
    assert abs(got.item() - want) < 5e-2 * abs(want)


def test_fused_route_matches_plain_route():
    x = torch.from_numpy(_episodes())
    losses = []
    for fused in (True, False):
        tm = DKT(ConvNet(2), WAY, SHOT, "bncossim", feature_dtype="float32",
                 use_fused_mll=fused, device="cpu").init(
                     x[0], torch.Generator().manual_seed(0))
        losses.append(tm.batch_loss_train(x)[0].item())
    assert abs(losses[0] - losses[1]) < 1e-4 * abs(losses[1])


def test_large_episodes_take_the_plain_route():
    """N = 5 * 30 = 150 > 128: the fused kernel does not apply, and the
    fused setting gives the plain route's loss."""
    x = torch.from_numpy(_episodes(b=1, query=28))
    losses = []
    for fused in (True, False):
        tm = DKT(ConvNet(2), WAY, SHOT, "cossim", feature_dtype="float32",
                 use_fused_mll=fused, device="cpu").init(
                     x[0], torch.Generator().manual_seed(0))
        losses.append(tm.batch_loss_train(x)[0].item())
    assert losses[0] == losses[1]


def test_fewer_ways_use_the_first_gps():
    tm = DKT(ConvNet(2), WAY, SHOT, "linear", feature_dtype="float32",
             device="cpu").init(torch.from_numpy(_episodes()[0]))
    with torch.no_grad():
        tm.gp.kernel.raw_outputscale.copy_(torch.arange(5.0))
    gp = tm._gp_params_for(3)
    assert gp["kernel"]["raw_outputscale"].tolist() == [0.0, 1.0, 2.0]
    assert gp["kernel"]["base"]["raw_variance"].shape == (3,)
    acc = tm.batch_correct(torch.from_numpy(_episodes()[:, :3]))
    assert acc.shape == (B,) and bool(((acc >= 0) & (acc <= 100)).all())
    with pytest.raises(ValueError):
        tm._gp_params_for(6)


def test_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DKT(ConvNet(2), WAY, SHOT)


def test_port_imports_no_jax():
    """With jax, flax, optax, matplotlib and sklearn unimportable, every
    module of the port imports (the regression track's, the sines scripts,
    the accuracy runners, the native decoder, the episode-parallel mesh,
    the profiling helpers, the export CLI, the Laplace probe and its copy
    of scikit-learn's classifier among them; importing builds no decoder
    and starts no process group), and a CPU train step and eval of DKT, of
    DKT regression and of the sines scripts, and the Laplace probe's arms
    on one episode, run; nothing of the JAX package or of scikit-learn
    gets loaded."""
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "matplotlib", "sklearn"):
    sys.modules[name] = None
import torch
import deep_kernel_transfer_tpu_torch as port
for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(mod.name)
new = ["methods.dkt_regression", "methods.feature_transfer", "data.qmul",
       "data.sines", "train_regression", "test_regression", "sines.common",
       "sines.train_DKT", "sines.train_FT", "sines.train_MAML",
       "benchmarks.regression_real", "native", "parallel.mesh",
       "utils.profiling", "export_checkpoint", "benchmarks.sklearn_gpc",
       "benchmarks.laplace_probe"]
missing = [n for n in new if port.__name__ + "." + n not in sys.modules]
assert not missing, missing
import torch.distributed as dist
from deep_kernel_transfer_tpu_torch import native
# importing built no decoder and started no process group
assert native._lib is None and not native._build_failed
assert not dist.is_initialized()
from deep_kernel_transfer_tpu_torch.methods import DKT, DKTRegression
from deep_kernel_transfer_tpu_torch.models import MLP2, ConvNet, Conv3
from deep_kernel_transfer_tpu_torch.sines import train_FT, train_MAML
x = torch.randint(0, 256, (2, 5, 3, 16, 16, 3), dtype=torch.uint8)
m = DKT(ConvNet(2), 5, 1, device="cpu").init(x[0])
assert torch.isfinite(m.train_step(x)["loss"])
m.batch_correct(x)
from deep_kernel_transfer_tpu_torch.benchmarks import laplace_probe
arms = laplace_probe.episode_arms(
    m, torch.randint(0, 256, (5, 16, 16, 16, 3), dtype=torch.uint8), 1)
assert arms["sklearn_float64"] and 0 <= arms["sklearn"] <= 100
r = DKTRegression(Conv3(), 144, "spectral", device="cpu").init()
xr = torch.rand(2, 19, 40, 40, 3)
assert torch.isfinite(r.unbatched_train_step(xr, torch.rand(2, 19))["loss"])
r.predict(xr[0, :5], torch.rand(5), xr[0])
for script in (train_FT, train_MAML):
    script.main(["--iterations=2", "--n_test_tasks=1", "--task_batch=2"],
                device="cpu")
loaded = [k for k, v in sys.modules.items() if v is not None
          and k.split(".")[0] in ("deep_kernel_transfer_tpu", "jax", "flax",
                                  "optax", "matplotlib", "sklearn")]
assert not loaded, loaded
print("PORT_OK")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "PORT_OK" in out.stdout, out.stderr
