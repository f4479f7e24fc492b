"""The port's DKT training held to the JAX package's over several steps
and epochs (ROADMAP C6): one init, one episode stream, each package's own
train step with its own per-epoch Adam reset.

`tests/test_torch_dkt.py` compares one train step. Here the JAX tests'
tiny trunk (ConvNetS(depth=2), 16 px, bncossim), 5-way 1-shot 3-query,
runs 2 epochs of 3 episodes, one episode a step, with the Adam reset
before each epoch, as both packages' `train_meta` do. The JAX package
takes its plain GP route (its default, JAX methods/dkt.py:91); the port
takes each of its two routes.

Tolerances, as the repo's parity tests state them: the forward 1e-5
(loss relative; `tests/test_pallas_mll.py:39`), the gradients 2e-2
relative (`:45`). In float32 the weights after the steps are held to 2e-2
of each tensor's norm: each Adam step moves a weight by about lr times the
sign of its gradient, so a gradient known to 2e-2 moves it that far at
most where its sign is in doubt. In float64 (both packages, the JAX
package's float32 names read as float64 in its trunk and GP modules; the
images normalised once in float32 and given to both as float64) the two
trajectories are held far tighter: 1e-10 for losses, weights and running
statistics on the plain route (the same arithmetic). The fused route adds
its 1e-6 jitter (ops/fused_mll.py) where the JAX plain route does not, a
1e-5 relative change of the noise, so it is held to 1e-6.

Run as a script, the file is the long form (ROADMAP C6, §(a)): the
digits_real 1-shot configuration (Conv4 as Conv4S at 28 px, bncossim,
5-way 1-shot 16-query, one episode a step, 100 episodes an epoch) from
one JAX init, the same numpy episode stream from the digits' base split,
for --epochs epochs, in float32 and float64 and the CLI's bfloat16, the
port on both routes; after each epoch the relative distance of trunk
weights, GP parameters and BatchNorm running statistics, the losses and
each model's accuracy on one fixed set of 600 novel episodes; a control
runs each package against itself from the init moved by one float32 ulp
(the port in float64 by one float64 ulp):

    JAX_PLATFORMS=cpu python tests/test_torch_dkt_trajectory.py \\
        --epochs 10 --out trajectory.json

With --jax_runs and --port_runs it scores §(b)'s runs instead: each
package's own 1-shot `train` CLI run (its default flags, --seed 1, 2, 3,
--stop_epoch=51), its epoch-50 checkpoint on one set of 600 novel
episodes:

    JAX_PLATFORMS=cpu python tests/test_torch_dkt_trajectory.py \\
        --jax_runs=j1,j2,j3 --port_runs=p1,p2,p3 --out checkpoints.json
"""
import argparse
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))  # the repo root, for a run as a script

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu.gp import kernels as jkernels
from deep_kernel_transfer_tpu.gp import likelihoods as jlikelihoods
from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.methods import base as jbase
from deep_kernel_transfer_tpu.methods.dkt import DKTState
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu_torch.methods import DKT
from deep_kernel_transfer_tpu_torch.models import ConvNet
from deep_kernel_transfer_tpu_torch.models.backbones import preprocess_input
from deep_kernel_transfer_tpu_torch.utils import convert
from torch_test_threads import one_thread  # noqa: F401

WAY, SHOT = 5, 1
FORWARD = 1e-5  # tests/test_pallas_mll.py:39
GRADIENT = 2e-2  # tests/test_pallas_mll.py:45
FLOAT64_PLAIN = 1e-10
FLOAT64_FUSED = 1e-6  # the fused route's 1e-6 jitter against 0.1 noise


class _Float64Names:
    """`jnp` with float32 read as float64: the JAX trunk's BatchNorm, its
    cast of the features back, and the GP's Gram and noise name float32
    outright; under this name the JAX package computes in float64 (its
    files are unchanged)."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


class Float64:
    """Context: JAX in float64 (x64 on, the float32 names patched), and
    the port's converter keeping float64."""

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        for mod in (jbb, jbase, jkernels, jlikelihoods):
            self.mp.setattr(mod, "jnp", _Float64Names())
        self.mp.setattr(convert, "_f32", lambda x: np.asarray(x, np.float64))
        self.x64 = jax.enable_x64(True)
        self.x64.__enter__()
        return self

    def __exit__(self, *exc):
        self.x64.__exit__(*exc)
        self.mp.undo()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ulp(tree):
    """Every float32 leaf moved by one ulp towards +inf."""
    return jax.tree.map(
        lambda a: np.nextafter(a, np.float32(np.inf)).astype(a.dtype)
        if a.dtype == np.float32 else a, tree)


def _inputs(x: np.ndarray, dtype: str):
    """The array both packages take: uint8 images as they are, or for a
    float64 run the images normalised once in float32 (the step both
    packages take first), as float64."""
    if dtype != "float64":
        return x
    return preprocess_input(torch.from_numpy(x)).double().numpy()


class JaxSide:
    """The JAX package's DKT on its plain GP route, from params."""

    def __init__(self, backbone, params, dtype: str, image_size: int):
        self.dtype, self.px = dtype, image_size
        self.jm = JDKT(backbone, WAY, SHOT, "bncossim", feature_dtype=dtype)
        if dtype == "float64":
            params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                  params)
        self.st = DKTState(params, self.jm.tx.init(params),
                           jnp.zeros((), jnp.int32))

    def reset(self):
        self.st = self.jm.reset_opt_state(self.st)

    def step(self, xb):
        self.st, m = self.jm.train_step(self.st, jnp.asarray(xb))
        return float(m["loss"])

    def state(self, tm):
        return {k: np.asarray(v, np.float64) for k, v in
                convert.dkt_state_from_jax(_np_tree(self.st.params), tm,
                                           self.px).items()}

    def accuracy(self, xb, chunk=100):
        return np.concatenate([np.asarray(self.jm.batch_correct(
            self.st.params, jnp.asarray(xb[i:i + chunk])))
            for i in range(0, len(xb), chunk)])


class PortSide:
    """The port's DKT on one route, loaded from the JAX params."""

    def __init__(self, backbone, params, dtype: str, image_size: int,
                 fused: bool, example):
        self.tm = DKT(backbone, WAY, SHOT, "bncossim", feature_dtype=dtype,
                      use_fused_mll=fused, device="cpu").init(
                          torch.from_numpy(example))
        convert.dkt_params_from_jax(_np_tree(params), self.tm, image_size)
        if dtype == "float64":
            self.tm.double()

    def reset(self):
        self.tm.reset_opt_state()

    def step(self, xb):
        return float(self.tm.train_step(torch.from_numpy(xb))["loss"])

    def state(self, tm=None):
        return {k: np.array(v.detach().double())
                for k, v in self.tm.state_dict().items()}

    @torch.no_grad()
    def accuracy(self, xb, chunk=100):
        return np.concatenate([self.tm.batch_correct(
            torch.from_numpy(xb[i:i + chunk])).numpy()
            for i in range(0, len(xb), chunk)])


GROUPS = {
    "trunk": lambda k: k.startswith("feature.") and "running" not in k,
    "gp": lambda k: k.startswith("gp."),
    "running": lambda k: "running_" in k,
}


def distances(a: dict, b: dict) -> dict:
    """Relative distance |a - b| / |b| over each group of tensors."""
    out = {}
    for group, has in GROUPS.items():
        keys = sorted(k for k in b if has(k) and k in a)
        da = np.concatenate([np.ravel(a[k]) for k in keys])
        db = np.concatenate([np.ravel(b[k]) for k in keys])
        out[group] = float(np.linalg.norm(da - db) / np.linalg.norm(db))
    return out


def train(side, epochs: list, dtype: str, eval_x=None, tm=None):
    """Each epoch: the package's Adam reset, then a step an episode batch.
    Returns the losses and, after each epoch, the state (port names) and
    the accuracy on eval_x."""
    losses, states, accs = [], [], []
    for batches in epochs:
        side.reset()
        losses.append([side.step(_inputs(xb, dtype)) for xb in batches])
        states.append(side.state(tm))
        if eval_x is not None:
            accs.append(float(side.accuracy(_inputs(eval_x, dtype)).mean()))
    return losses, states, accs


# -- the short form, at the JAX tests' size --------------------------------

PX, QUERY = 16, 3


def _tiny_episodes(seed=0):
    """2 epochs of 3 one-episode batches [1, 5, 1+3, 16, 16, 3], uint8."""
    rng = np.random.RandomState(seed)
    return [[rng.randint(0, 256, (1, WAY, SHOT + QUERY, PX, PX, 3)).astype(
        np.uint8) for _ in range(3)] for _ in range(2)]


def _tiny_params(example):
    jm = JDKT(jbb.ConvNetS(depth=2), WAY, SHOT, "bncossim",
              feature_dtype="float32")
    return _np_tree(jm.init(jax.random.PRNGKey(0),
                            jnp.asarray(example)).params)


def _run_pair(dtype: str, fused: bool):
    epochs = _tiny_episodes()
    example = epochs[0][0][0]
    params = _tiny_params(example)
    port = PortSide(ConvNet(2, first_channel=True), params, dtype, PX, fused,
                    example)
    if dtype == "float64":
        with Float64():
            jside = JaxSide(jbb.ConvNetS(depth=2), params, dtype, PX)
            jl, js, _ = train(jside, epochs, dtype, tm=port.tm)
    else:
        jside = JaxSide(jbb.ConvNetS(depth=2), params, dtype, PX)
        jl, js, _ = train(jside, epochs, dtype, tm=port.tm)
    pl_, ps, _ = train(port, epochs, dtype)
    return np.asarray(jl), np.asarray(pl_), js, ps, port


@pytest.fixture(scope="module", params=[True, False], ids=["fused", "plain"])
def pairs(request):
    """(fused, {dtype: (JAX losses, port losses, JAX states, port states,
    port)}) for 2 epochs of 3 steps in float64 and float32."""
    return request.param, {dtype: _run_pair(dtype, request.param)
                           for dtype in ("float64", "float32")}


def test_two_epochs_float64_match_jax(pairs):
    """Six steps across one Adam reset with both packages in float64: the
    losses, and every tensor after each epoch (weights, GP parameters,
    running statistics), agree to float64 rounding on the plain route; on
    the fused route, whose jitter moves the loss by 6.0e-6 relative here,
    the losses within the forward tolerance and the tensors within 1e-6. A
    fault in the Adam reset, the two learning rates or the running-average
    merge moves them by 1e-4 or more (test_adam_restarts_each_epoch)."""
    fused, runs = pairs
    jl, pl_, js, ps, port = runs["float64"]
    assert next(port.tm.parameters()).dtype == torch.float64
    loss_limit = FORWARD if fused else FLOAT64_PLAIN
    assert np.all(np.abs(pl_ - jl) <= loss_limit * np.abs(jl)), (pl_ - jl)
    limit = FLOAT64_FUSED if fused else FLOAT64_PLAIN
    for j, p in zip(js, ps):
        assert set(j) <= set(p)
        for group, d in distances(p, j).items():
            assert d < limit, (group, d)


def test_two_epochs_float32_match_jax(pairs):
    """The same six steps in float32: every loss within the forward
    tolerance of the JAX loss once the route's own shift (the float64 gap
    of the same step: the fused route's jitter, 0 on the plain route) is
    taken off; the weights, GP parameters and running statistics after
    each epoch within the gradient tolerance of their norm."""
    _, runs = pairs
    jl, pl_, js, ps, _ = runs["float32"]
    jl64, pl64 = runs["float64"][:2]
    gap = (pl_ - jl) - (pl64 - jl64)
    assert np.all(np.abs(gap) <= FORWARD * np.abs(jl)), gap
    for j, p in zip(js, ps):
        for group, d in distances(p, j).items():
            assert d < GRADIENT, (group, d)


def test_adam_restarts_each_epoch():
    """The reset is what both packages do: the port's first step of the
    second epoch equals a fresh model's first step from the same weights,
    and a run without the reset parts from the JAX package."""
    epochs = _tiny_episodes()
    example = epochs[0][0][0]
    params = _tiny_params(example)

    def port():
        return PortSide(ConvNet(2, first_channel=True), params, "float64",
                        PX, False, example)

    with_reset = port()
    train(with_reset, epochs, "float64")
    no_reset = port()
    no_reset.reset()
    for batches in epochs:
        for xb in batches:
            no_reset.step(_inputs(xb, "float64"))
    with Float64():
        jside = JaxSide(jbb.ConvNetS(depth=2), params, "float64", PX)
        _, js, _ = train(jside, epochs, "float64", tm=with_reset.tm)
    assert distances(with_reset.state(), js[-1])["trunk"] < FLOAT64_PLAIN
    assert distances(no_reset.state(), js[-1])["trunk"] > 1e-4


# -- the long form ------------------------------------------------------------

def digits_pools(root: str, image_size: int = 28):
    """(base images, base labels, novel images, novel labels): the
    digits_real splits, decoded and staged by the port as its CLIs do."""
    from deep_kernel_transfer_tpu_torch.benchmarks.digits_real import \
        make_digits_filelists
    from deep_kernel_transfer_tpu_torch.data.device_dataset import \
        DeviceDataset
    make_digits_filelists(root)
    out = []
    for split in ("base", "novel"):
        ds = DeviceDataset(os.path.join(root, "filelists", "omniglot",
                                        f"{split}.json"), image_size,
                           device="cpu")
        out += [ds.images.numpy(), ds.image_labels]
    return out


def draw_episodes(rng, images, labels, n, shot, query):
    """n episodes [n, 5, shot+query, H, W, 3] uint8: 5 classes, then
    shot+query images of each without replacement, from rng."""
    classes = np.unique(labels)
    by_class = {c: np.flatnonzero(labels == c) for c in classes}
    out = np.empty((n, WAY, shot + query) + images.shape[1:], np.uint8)
    for e in range(n):
        for w, c in enumerate(rng.permutation(classes)[:WAY]):
            out[e, w] = images[rng.choice(by_class[c], shot + query,
                                          replace=False)]
    return out


def long_form(args) -> dict:
    torch.set_num_threads(args.threads)
    root = tempfile.mkdtemp(prefix="dkt_trajectory_")
    base_x, base_y, novel_x, novel_y = digits_pools(root)
    rng = np.random.RandomState(args.seed)
    epochs = [[draw_episodes(rng, base_x, base_y, 1, SHOT, 16)
               for _ in range(args.episodes)] for _ in range(args.epochs)]
    eval_x = draw_episodes(np.random.RandomState(args.seed + 1), novel_x,
                           novel_y, args.eval_episodes, SHOT, 15)
    example = epochs[0][0][0]
    jm = JDKT(jbb.Conv4S(), WAY, SHOT, "bncossim", feature_dtype="float32")
    params = _np_tree(jm.init(jax.random.PRNGKey(args.seed),
                              jnp.asarray(example)).params)
    report = {"config": vars(args), "runs": {}}

    def run(name, side, dtype, tm):
        t0 = time.perf_counter()
        losses, states, accs = train(side, epochs, dtype, eval_x, tm)
        print(f"{name}: {time.perf_counter() - t0:.1f} s, accuracy "
              f"{accs}", flush=True)
        return dict(losses=losses, states=states, accs=accs)

    def port(p, dtype, fused, ulp64=False):
        side = PortSide(ConvNet(4, first_channel=True), p, dtype, 28, fused,
                        example)
        if ulp64:  # the float64 control: the init moved by a float64 ulp
            with torch.no_grad():
                for t in side.tm.parameters():
                    t.copy_(torch.nextafter(t, torch.full_like(t, np.inf)))
        return side

    def jax_side(p, dtype):
        return JaxSide(jbb.Conv4S(), p, dtype, 28)

    for dtype in args.dtypes.split(","):
        runs = {}
        ref = port(params, dtype, False).tm
        if args.skip_jax:
            pass
        elif dtype == "float64":
            with Float64():
                runs["jax"] = run("jax float64", jax_side(params, dtype),
                                  dtype, ref)
        else:
            runs["jax"] = run(f"jax {dtype}", jax_side(params, dtype), dtype,
                              ref)
            runs["jax_ulp"] = run(f"jax {dtype} ulp",
                                  jax_side(_ulp(params), dtype), dtype, ref)
        for route in args.routes.split(","):
            runs[f"port_{route}"] = run(
                f"port {route} {dtype}",
                port(params, dtype, route == "fused"), dtype, None)
        route = args.routes.split(",")[0]
        runs[f"port_{route}_ulp"] = run(
            f"port {route} {dtype} ulp",
            port(params, dtype, route == "fused", ulp64=True)
            if dtype == "float64" else
            port(_ulp(params), dtype, route == "fused"), dtype, None)
        pairs = {f"{r}_vs_jax": (r, "jax") for r in runs if "jax" in runs
                 and r.startswith("port_") and not r.endswith("_ulp")}
        pairs.update({f"{r}_vs_{r[:-4]}": (r, r[:-4]) for r in runs
                      if r.endswith("_ulp")})
        out = {}
        for label, (a, b) in pairs.items():
            out[label] = {
                "distance": [distances(sa, sb) for sa, sb in
                             zip(runs[a]["states"], runs[b]["states"])],
                "loss_gap": [float(np.mean(np.abs(np.asarray(la)
                                                   - np.asarray(lb))))
                             for la, lb in zip(runs[a]["losses"],
                                               runs[b]["losses"])]}
        out["epoch_loss"] = {r: [float(np.mean(x)) for x in v["losses"]]
                             for r, v in runs.items()}
        out["accuracy"] = {r: v["accs"] for r, v in runs.items()}
        report["runs"][dtype] = out
        print(json.dumps({dtype: out}), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
    return report


CLI_FLAGS = ["--dataset=omniglot", "--model=Conv4", "--method=DKT",
             "--train_n_way=5", "--test_n_way=5", "--n_shot=1"]


def score_checkpoints(args) -> dict:
    """ROADMAP C6, §(b): the epoch --save_iter checkpoint of each run
    directory (each package's own `train` CLI run in it, 1 shot, cut to
    51 epochs) tested by its own package on one set of --eval_episodes
    novel episodes drawn with numpy, each package's eval head as its
    `test` CLI builds it (bfloat16 trunk, eval-mode BatchNorm, the GP on
    the support set); each JAX checkpoint also through the port's head
    (the port reads the JAX checkpoints)."""
    from deep_kernel_transfer_tpu import factory as jfactory
    from deep_kernel_transfer_tpu.io_utils import parse_args as jparse
    from deep_kernel_transfer_tpu.utils.checkpoint import (
        load_params_checkpoint, resolve_checkpoint_file)
    from deep_kernel_transfer_tpu_torch.io_utils import parse_args
    from deep_kernel_transfer_tpu_torch.test import load_model

    torch.set_num_threads(args.threads)
    root = tempfile.mkdtemp(prefix="dkt_checkpoints_")
    _, _, novel_x, novel_y = digits_pools(root)
    eval_x = draw_episodes(np.random.RandomState(args.seed + 1), novel_x,
                           novel_y, args.eval_episodes, SHOT, 15)
    flags = CLI_FLAGS + [f"--save_iter={args.save_iter}"]
    out = {}
    cwd = os.getcwd()
    for pkg, dirs in (("jax", args.jax_runs), ("port", args.port_runs)):
        for d in (x for x in dirs.split(",") if x):
            os.chdir(d)
            try:
                if pkg == "port":
                    tm = load_model(parse_args("test", flags), 1, "cpu")
                    acc = PortSide.accuracy(SimpleNamespace(tm=tm), eval_x)
                else:
                    p = jparse("test", flags)
                    jfactory.check_model_constraints(p)
                    jm = jfactory.build_method(p, WAY, SHOT)
                    st = jm.init(jax.random.PRNGKey(1), jnp.asarray(
                        eval_x[0]))
                    params, _ = load_params_checkpoint(
                        resolve_checkpoint_file(jfactory.checkpoint_dir(p),
                                                args.save_iter),
                        st.params, method_name="DKT", model=jm,
                        image_size=28)
                    acc = JaxSide.accuracy(SimpleNamespace(
                        jm=jm, st=SimpleNamespace(params=params)), eval_x)
                    # the port's head on the JAX checkpoint: train and
                    # test told apart
                    tm = load_model(parse_args("test", flags), 1, "cpu")
                    out[f"jax_by_port:{d}"] = float(np.mean(
                        PortSide.accuracy(SimpleNamespace(tm=tm), eval_x)))
            finally:
                os.chdir(cwd)
            out[f"{pkg}:{d}"] = float(np.mean(acc))
            print(f"{pkg} {d}: {out[f'{pkg}:{d}']:.2f}%", flush=True)
    for pkg in ("jax", "port", "jax_by_port"):
        accs = [v for k, v in out.items() if k.startswith(pkg + ":")]
        if accs:
            out[f"{pkg}_mean"] = float(np.mean(accs))
            out[f"{pkg}_std"] = float(np.std(accs))
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--episodes", type=int, default=100)
    ap.add_argument("--eval_episodes", type=int, default=600)
    ap.add_argument("--dtypes", default="float32,float64,bfloat16")
    ap.add_argument("--routes", default="fused,plain")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip_jax", action="store_true",
                    help="the port's runs and its control only")
    ap.add_argument("--jax_runs", default=None,
                    help="score checkpoints instead: comma list of run "
                         "directories of the JAX train CLI")
    ap.add_argument("--port_runs", default="",
                    help="... and of the port's train CLI")
    ap.add_argument("--save_iter", type=int, default=50)
    a = ap.parse_args()
    if a.jax_runs is not None:
        score_checkpoints(a)
    else:
        long_form(a)
    sys.exit(0)
