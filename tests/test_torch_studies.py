"""The port's study runners (deep_kernel_transfer_tpu_torch/benchmarks:
profile_step, profile_resnet, gp_probe_ab, peak_sweep, train_cli_e2e,
dkt_sweep) against the JAX package and its benchmarks/ scripts, on the
same numpy inputs and carried-over weights:

  * each profiled segment (trunk forward in train and eval mode, the
    gradient of the trunk's sum of squares, the loss and its gradient)
    against the JAX DKT's `_features`, `jax.grad`, `batch_loss` and
    `jax.grad(batch_loss)`: ConvNetS(depth=2) at 16 px and 2 episodes,
    ResNet10 at 32 px and 1 episode; f32 trunks;
  * the probe's two arms bit-identical to each other and equal to the JAX
    tail (value and gradients);
  * the peak chain against float64 numpy, and its TFLOP/s arithmetic;
  * the CLI-throughput dataset byte-equal to the JAX make_dataset's;
  * the knee's "oom" row, and any other error propagating;
  * the sweep's epoch list and row keys against the JAX script's rows in
    benchmarks/report.json;
  * each runner's `main(argv, device="cpu")` at a tiny size writing the
    JAX key names, and raising without CUDA unless the CPU is asked.

Tolerances (ROADMAP ground rules, tests/test_torch_dkt.py): features 1e-5
absolute, losses 1e-4 relative, gradients 2e-2 of each leaf's largest
entry, floored at 1e-4; a conv bias before a train-mode BatchNorm has an
exact gradient of 0, so both sides must be rounding there, below 1e-3 of
the conv weight's gradient (tests/test_torch_methods_zoo.py). Timings
here are host-clock readings of the CPU and are not checked.
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu.gp import (ExactGP as JExactGP,
                                         GaussianLikelihood as JLikelihood,
                                         make_kernel as jmake_kernel)
from deep_kernel_transfer_tpu.gp.exact import (init_batched as jinit_batched,
                                               sum_mll as jsum_mll)
from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.methods.base import (
    one_vs_rest_targets as jtargets)
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu_torch import test as ttest
from deep_kernel_transfer_tpu_torch import train as ttrain
from deep_kernel_transfer_tpu_torch.benchmarks import (dkt_sweep, gp_probe_ab,
                                                       peak_sweep,
                                                       profile_resnet,
                                                       profile_step,
                                                       train_cli_e2e)
from deep_kernel_transfer_tpu_torch.gp import (ExactGP, GaussianLikelihood,
                                               make_kernel)
from deep_kernel_transfer_tpu_torch.gp.exact import init_batched
from deep_kernel_transfer_tpu_torch.methods import DKT
from deep_kernel_transfer_tpu_torch.models import ConvNet, ResNet10
from deep_kernel_transfer_tpu_torch.utils.convert import (dkt_params_from_jax,
                                                          dkt_state_from_jax,
                                                          flatten_perm)
from torch_test_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAY, SHOT, QUERY = 5, 5, 15
RUNNERS = (profile_step, profile_resnet, gp_probe_ab, peak_sweep,
           train_cli_e2e, dkt_sweep)


@pytest.fixture(scope="module")
def jax_report():
    with open(os.path.join(REPO, "benchmarks", "report.json")) as f:
        return json.load(f)


def _jax_script(name: str):
    """A JAX benchmarks/ script, imported with benchmarks/ first on
    sys.path, as running it puts it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(os.path.join(REPO, "benchmarks"))
        return importlib.import_module(name)


# -- profile_step / profile_resnet: the segments -----------------------------

def _segments_pair(jtrunk, ttrunk, px: int, b: int):
    """(port segments' outputs, the JAX counterparts' outputs, port DKT,
    x) for a DKT bncossim on the two trunks with the JAX weights."""
    xb = np.random.RandomState(3).randint(
        0, 256, (b, WAY, SHOT + QUERY, px, px, 3)).astype(np.uint8)
    jm = JDKT(jtrunk, WAY, SHOT, "bncossim", feature_dtype="float32")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(xb[0])).params
    tm = DKT(ttrunk, WAY, SHOT, "bncossim", feature_dtype="float32",
             device="cpu").init(torch.from_numpy(xb[0]))
    dkt_params_from_jax(jax.tree.map(np.asarray, params), tm, px)
    x = torch.from_numpy(xb)
    fns = profile_step.segments(tm, x)
    got = {name: fns[name]() for name in ("trunk_fwd", "trunk_fwd_eval",
                                          "trunk_fwd_bwd", "loss_fwd",
                                          "loss_fwd_bwd")}

    xj = jnp.asarray(xb)
    flat = xj.reshape((-1,) + xj.shape[3:])

    def trunk(p, train):
        return jm._features(p, flat, train=train, ep_groups=b)[0]

    want = {"trunk_fwd": trunk(params, True),
            "trunk_fwd_eval": trunk(params, False),
            "trunk_fwd_bwd": jax.grad(
                lambda q: jnp.sum(trunk(q, True) ** 2))(params),
            "loss_fwd": jm.batch_loss(params, xj),
            "loss_fwd_bwd": jax.grad(jm.batch_loss)(params, xj)}
    return got, want, tm, px


def _check_segments(got, want, tm, px):
    perm = flatten_perm(tm.feature, px)  # the port's features are CHW
    for name in ("trunk_fwd", "trunk_fwd_eval"):
        err = np.abs(got[name].numpy()[:, perm] - np.asarray(want[name])).max()
        assert err < 1e-5, (name, err)
    lw = float(want["loss_fwd"])
    assert abs(float(got["loss_fwd"]) - lw) < 1e-4 * abs(lw)
    for name, params in (("trunk_fwd_bwd", tm.feature.named_parameters(
            prefix="feature")), ("loss_fwd_bwd", tm.named_parameters())):
        names = [n for n, _ in params]
        jgrads = dkt_state_from_jax(jax.tree.map(np.asarray, want[name]),
                                    tm, px)
        assert len(got[name]) == len(names)
        grads = dict(zip(names, (g.numpy() for g in got[name])))
        for n, g in grads.items():
            w = jgrads[n]
            if n.endswith(".C.bias"):  # before a train-mode BatchNorm: 0
                scale = np.abs(grads[n[:-4] + "weight"]).max()
                assert max(np.abs(g).max(), np.abs(w).max()) < 1e-3 * scale
            else:
                scale = max(np.abs(w).max(), 1e-4)
                assert np.abs(g - w).max() < 2e-2 * scale, (name, n)


def test_profile_step_segments_match_jax():
    _check_segments(*_segments_pair(jbb.ConvNetS(depth=2),
                                    ConvNet(2, first_channel=True), 16, 2))


def test_profile_resnet_segments_match_jax():
    _check_segments(*_segments_pair(jbb.ResNet10(), ResNet10(), 32, 1))


def test_derived_rows_are_the_jax_scripts():
    ms = {"trunk_fwd_bwd_ms": 80.0, "loss_fwd_bwd_ms": 90.0,
          "train_step_ms": 100.0}
    assert profile_step.derived(ms, 32) == {
        "gp_share_ms": 10.0, "opt_overhead_ms": 10.0,
        "eps_per_sec_at_step": 320.0}


# -- profile_resnet: the knee -----------------------------------------------

def test_knee_writes_oom_and_raises_any_other_error(monkeypatch, tmp_path):
    report = str(tmp_path / "r.json")
    model = DKT(ConvNet(2), WAY, SHOT, device="cpu").init(
        torch.zeros((WAY, SHOT + QUERY, 16, 16, 3), dtype=torch.uint8))

    def step(model, b, px, device, reps, rounds):
        if b == 24:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        if b == 99:
            raise RuntimeError("not an allocation")
        return float(b)

    monkeypatch.setattr(profile_resnet, "step_eps_per_sec", step)
    rows = profile_resnet.knee(model, [8, 24, 32], 224, torch.device("cpu"),
                               1, 1, report)
    want = {"resnet10_224_knee_b8_eps_per_sec": 8.0,
            "resnet10_224_knee_b24_eps_per_sec": "oom",
            "resnet10_224_knee_b32_eps_per_sec": 32.0}
    assert rows == want
    with open(report) as f:
        assert json.load(f) == want
    with pytest.raises(RuntimeError, match="not an allocation"):
        profile_resnet.knee(model, [99], 224, torch.device("cpu"), 1, 1,
                            report)


# -- gp_probe_ab --------------------------------------------------------------

def _leaves(tree, path=()):
    """{key path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def test_probe_arms_bit_identical_and_equal_to_the_jax_tail():
    b = 2
    z = gp_probe_ab.tail_inputs(b, torch.device("cpu"))
    probed = gp_probe_ab.tail(False, z)()
    assume = gp_probe_ab.tail(True, z)()
    assert all(torch.equal(p, a) for p, a in zip(probed, assume))

    gp = JExactGP(jmake_kernel("bncossim"),
                  JLikelihood(trainable=False, fixed_noise=gp_probe_ab.NOISE),
                  force_dense=True)
    params = jinit_batched(gp, jax.random.PRNGKey(0), gp_probe_ab.N_WAY)
    targets = jtargets(gp_probe_ab.N_WAY, gp_probe_ab.N_TOTAL)

    def loss(p, zz):
        return jnp.mean(jax.vmap(lambda ze: -jsum_mll(gp, p, ze, targets))(zz))

    value, (gp_g, z_g) = jax.value_and_grad(loss, argnums=(0, 1))(
        params, jnp.asarray(z.numpy()))
    assert abs(float(probed[0]) - float(value)) < 1e-4 * abs(float(value))
    jleaves = _leaves(jax.tree.map(np.asarray, gp_g))
    tleaves = _leaves(init_batched(ExactGP(
        make_kernel("bncossim"), GaussianLikelihood(trainable=False),
        force_dense=True), gp_probe_ab.N_WAY, device="cpu"))
    assert set(tleaves) <= set(jleaves)
    for got, key in zip(probed[1:-1], tleaves):  # the port's leaf order
        w = jleaves[key]
        assert np.abs(got.numpy() - w).max() < 2e-2 * max(
            np.abs(w).max(), 1e-4), key
    w = np.asarray(z_g)
    assert np.abs(probed[-1].numpy() - w).max() < 2e-2 * np.abs(w).max()


# -- peak_sweep ---------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
def test_peak_chain_against_float64(dtype, tol):
    n, k = 64, 4
    rng = np.random.RandomState(0)
    y, b = rng.randn(n, n), rng.randn(n, n)
    want = y
    for _ in range(k):
        want = (want @ b) / np.sqrt(n)
    got = peak_sweep.chain(torch.tensor(y).to(dtype),
                           (torch.tensor(b) / n ** 0.5).to(dtype), k)
    err = np.abs(got.double().numpy() - want).max()
    assert err < tol * np.abs(want).max(), err


def test_peak_chain_call_carries_y_on():
    n, k = 32, 3
    fn = peak_sweep.chain_call(n, torch.float32, k, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    y = torch.randn((n, n), generator=gen)
    b = torch.randn((n, n), generator=gen) / n ** 0.5
    fn()
    out = fn()
    assert torch.allclose(out, peak_sweep.chain(y, b, 2 * k), rtol=1e-5,
                          atol=1e-5)


def test_peak_tflops_arithmetic():
    # 4 chains of 32 products of 8192 x 8192 in 100 ms
    assert peak_sweep.tflops(8192, 32, 4, 100.0) == pytest.approx(
        2 * 8192 ** 3 * 32 * 4 / 0.1 / 1e12)


# -- train_cli_e2e ------------------------------------------------------------

def test_train_cli_dataset_bytes_equal_the_jax_script(tmp_path):
    jscript = _jax_script("train_cli_e2e")
    jscript.make_dataset(str(tmp_path))
    want = {}
    for dirpath, _, files in os.walk(tmp_path):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                want[os.path.relpath(os.path.join(dirpath, f),
                                     tmp_path)] = fh.read()
    os.rename(tmp_path / "filelists", tmp_path / "jax_filelists")
    train_cli_e2e.make_dataset(str(tmp_path))
    assert len(want) == 30 * 40 + 2
    for rel, data in want.items():
        with open(tmp_path / rel, "rb") as fh:
            assert fh.read() == data, rel


# -- dkt_sweep ----------------------------------------------------------------

def _fake_clis(monkeypatch, epochs: dict, calls: list):
    """train.main writes <epoch>.tar for `epochs[shot]` and
    best_model.tar; test.main returns a fixed accuracy."""

    def train_main(argv, device=None):
        calls.append(("train", argv))
        shot = int(next(a for a in argv if a.startswith("--n_shot="))[9:])
        ck = dkt_sweep.default_ckdir(shot)
        os.makedirs(ck, exist_ok=True)
        for e in epochs.get(shot, [0]):
            open(os.path.join(ck, f"{e}.tar"), "w").close()
        open(os.path.join(ck, "best_model.tar"), "w").close()

    def test_main(argv, device=None, return_runs=False):
        calls.append(("test", argv))
        return (50.0, 1.0, [49.0, 51.0]) if return_runs else (50.0, 1.0)

    monkeypatch.setattr(ttrain, "main", train_main)
    monkeypatch.setattr(ttest, "main", test_main)


def test_dkt_sweep_epochs_and_keys_equal_the_jax_scripts(monkeypatch,
                                                        tmp_path, jax_report):
    """With the CLIs faked, the sweep tests every checkpoint the default
    run saved (the JAX rows' epochs) and writes the JAX rows' keys."""
    jkeys = {k for k in jax_report if k.startswith("digits_real_dkt_")}
    epochs = {s: sorted(int(k.split("_ep")[1].split("_")[0]) for k in jkeys
                        if k.startswith(f"digits_real_dkt_5way_{s}shot_ep")
                        and k.endswith("_acc")) for s in (1, 5)}
    assert epochs[5][-2:] == [350, 399] and epochs[1][-1] == 599
    calls, report = [], str(tmp_path / "r.json")
    _fake_clis(monkeypatch, epochs, calls)
    root = str(tmp_path / "root")
    rows = dkt_sweep.main([f"--root={root}", f"--report={report}"],
                          device="cpu")
    trained = len([c for c in calls if c[0] == "train"])
    rows.update(dkt_sweep.main([f"--root={root}", f"--report={report}",
                                "--early_stop_only"], device="cpu"))
    assert len([c for c in calls if c[0] == "train"]) == trained  # reused
    keys = {k for k in rows if not k.endswith("sweep_train_s")}
    assert keys == {k for k in jkeys if "_ep" in k or "earlystop" in k
                    or any(f"_dkt_{kern}_5way_5shot" in k for kern in
                           ("rbf", "matern", "cossim", "linear"))}
    tested = [a for kind, a in calls if kind == "test"
              and "--repeat=1" in a and "--n_shot=5" in a]
    assert [int(a[-2][len("--save_iter="):]) for a in tested] == epochs[5]
    assert ("train", dkt_sweep.cli(5, ["--kernel_type=rbf", "--resume"])
            ) in calls
    with open(report) as f:
        assert "digits_real_dkt_sweep_card" in json.load(f)


# -- main() of each runner at a tiny size -------------------------------------

def test_runners_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for runner in RUNNERS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runner.main(["--report=/nonexistent/r.json"])


def _jax_names(jax_report, prefix, ours):
    """The JAX rows of `prefix` (but its protocol), renamed to `ours`."""
    return {ours + k[len(prefix):] for k in jax_report
            if k.startswith(prefix) and "protocol" not in k}


TIMING_MAINS = {
    # Conv4 at 16 px and ResNet10 at 32 px (so its rows are resnet10_32_*),
    # one episode; the probe at one episode; the chain at N = 32 and 64
    "profile_step": (["--batch=1", "--reps=1", "--rounds=1"],
                     [("profile_b32_", "profile_b1_")], ()),
    "profile_resnet": (["--profile_batch=1", "--batches=1,2", "--reps=1",
                        "--rounds=1"],
                       [("resnet10_224_profile_b16_",
                         "resnet10_32_profile_b1_"),
                        ("resnet10_224_knee_b8_", "resnet10_32_knee_b1_"),
                        ("resnet10_224_knee_b8_", "resnet10_32_knee_b2_")],
                       ()),
    # the JAX script's names (benchmarks/gp_probe_ab.py:81-89; the JAX
    # report holds no probe rows)
    "gp_probe_ab": (["--batch=1", "--reps=1", "--rounds=1"], [],
                    ("gp_probe_ab_tail_probed_ms",
                     "gp_probe_ab_tail_assume_pd_ms", "gp_probe_ab_saved_ms",
                     "gp_probe_ab_protocol")),
    "peak_sweep": (["--bf16_sizes=64", "--f32_sizes=32,64", "--chain=2",
                    "--rounds=1"], [],
                   ("gpu_peak_bfloat16_64_tflops",
                    "gpu_peak_float32_32_tflops",
                    "gpu_peak_float32_64_tflops",
                    "gpu_peak_attainable_bf16_tflops", "gpu_peak_protocol")),
}


@pytest.mark.parametrize("name", list(TIMING_MAINS))
def test_timing_runner_main_writes_the_jax_key_names(name, monkeypatch,
                                                     tmp_path, jax_report):
    """A timing runner's main on the CPU at a tiny size writes the JAX
    script's key names (tpu_ as gpu_), each row finite."""
    argv, renames, extra = TIMING_MAINS[name]
    report = str(tmp_path / "studies.json")
    monkeypatch.setattr(profile_step, "HW", 16)
    monkeypatch.setattr(profile_resnet, "HW", 32)
    runner = {r.__name__.split(".")[-1]: r for r in RUNNERS}[name]
    runner.main(argv + [f"--report={report}"], device="cpu")
    with open(report) as f:
        rows = json.load(f)
    want = set(extra).union(*(_jax_names(jax_report, p, o)
                              for p, o in renames))
    assert len(want) >= 3 and not want - set(rows), want - set(rows)
    for k in want:
        assert isinstance(rows[k], str) or np.isfinite(rows[k]), k


def test_train_cli_main_differences_three_runs(monkeypatch, tmp_path,
                                               jax_report):
    """train_cli_e2e.main runs train.main with the JAX script's flags for
    1, 1 and 1 + N epochs in the dataset's directory and writes the JAX
    rows from their wall times. train.main is faked here: one real train
    step at 84 px takes seconds on one CPU thread, and the CLI itself is
    held to the JAX one by tests/test_torch_cli.py."""
    calls = []

    def train_main(argv, device=None):
        calls.append((argv, os.getcwd()))

    monkeypatch.setattr(ttrain, "main", train_main)
    report, root = str(tmp_path / "studies.json"), tmp_path / "cli"
    rows = train_cli_e2e.main(["--episodes=4", "--epochs=3", f"--root={root}",
                               f"--report={report}"], device="cpu")
    jscript = _jax_script("train_cli_e2e")
    assert [a[-1] for a, _ in calls] == [
        "--stop_epoch=1", "--stop_epoch=1", "--stop_epoch=4"]
    flags = train_cli_e2e.train_args(4)
    assert all(a[:-1] == flags and cwd == str(root) for a, cwd in calls)
    # the JAX script's flags (benchmarks/train_cli_e2e.py:69-72)
    assert train_cli_e2e.train_args(jscript.N_EPISODES) == [
        "--dataset=CUB", "--model=Conv4", "--method=DKT", "--train_n_way=5",
        "--test_n_way=5", "--n_shot=5", "--seed=1", "--train_aug",
        "--device_data=on", "--episode_batch=16", "--n_train_episodes=200",
        "--save_freq=1000"]
    assert (train_cli_e2e.N_EPISODES, train_cli_e2e.N_EPOCHS) == (
        jscript.N_EPISODES, jscript.N_EPOCHS)
    assert os.path.exists(root / "filelists" / "CUB" / "base.json")
    want = {k for k in jax_report if k.startswith("train_cli_")}
    assert len(want) == 4 and want <= set(rows)
    with open(report) as f:
        assert want <= set(json.load(f))
