"""The port's episode parallelism (deep_kernel_transfer_tpu_torch/parallel)
against one process and against the JAX package's sharded step, with real
processes: two gloo ranks on the CPU, started by parallel.spawn_ranks.

DKT on ConvNetS(depth=2), float32 trunk, 3-way 2-shot 3-query, 16 px,
B = 8 episodes (4 a rank). Tolerances are the JAX package's own
(tests/test_parallel.py:48-55): loss 1e-4 relative, gradients rtol 5e-3
and atol 1e-5; eval accuracies 1e-4. The JAX side's gradients come from
its sharded value_and_grad on a 2-device mesh of the virtual CPU devices,
its loss from its make_sharded_train_step, from the weights the port
carries over with utils.convert.dkt_params_from_jax.

The CLI cases run `train --n_devices=2` and `test --n_devices=2` (this
process is rank 0, one spawned process rank 1), and `train` in two
processes that torchrun starts, against the 1-rank runs of the same seed
on an omniglot-layout set. Torch is held to one thread here and in the
ranks (OMP_NUM_THREADS=1).
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu import parallel as jpar
from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu_torch import factory
from deep_kernel_transfer_tpu_torch import test as ttest
from deep_kernel_transfer_tpu_torch import train as ttrain
from deep_kernel_transfer_tpu_torch.data.device_dataset import DeviceDataset
from deep_kernel_transfer_tpu_torch.io_utils import parse_args
from deep_kernel_transfer_tpu_torch.methods import DKT, BaselineTrain
from deep_kernel_transfer_tpu_torch.models import ConvNet
from deep_kernel_transfer_tpu_torch.parallel import (
    Mesh, average, distribute_local_episodes, make_mesh, make_sharded_eval,
    make_sharded_train_step, replicate_tree, shard_episode_batch,
    spawn_ranks, wrap_pad_episodes)
from deep_kernel_transfer_tpu_torch.parallel.mesh import free_port
from deep_kernel_transfer_tpu_torch.utils.convert import (
    dkt_params_from_jax, dkt_state_from_jax)
from torch_test_threads import one_thread  # noqa: F401

B, WAY, SHOT, QUERY, PX = 8, 3, 2, 3, 16
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model():
    return DKT(ConvNet(2, first_channel=True), WAY, SHOT, "bncossim",
               feature_dtype="float32", device="cpu")


def _episodes(seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (B, WAY, SHOT + QUERY, PX, PX, 3)).astype(np.uint8)


def _sharded_step(x: np.ndarray, state: dict) -> dict:
    """On each of 2 ranks: rank 0's weights broadcast, one sharded train
    step on the rank's 4 episodes, the sharded eval of all 8. Returns (on
    rank 0) the loss, the averaged gradients, the weights after the step,
    the accuracies and the largest difference of any weight between the
    ranks."""
    mesh = make_mesh(2, "cpu")
    model = _model().init(torch.from_numpy(x[0]))  # each rank draws its own
    if mesh.rank == 0:
        model.load_state_dict(state)
    replicate_tree([model, model.optimizer], mesh)
    m = make_sharded_train_step(model, mesh)(shard_episode_batch(x, mesh))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    flat = torch.cat([v.reshape(-1).float()
                      for v in model.state_dict().values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    spread = (flat - ref).abs().max().reshape(1)
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    accs = make_sharded_eval(model, mesh)(shard_episode_batch(x, mesh))
    return {"loss": float(m["loss"]), "grads": grads,
            "state": model.state_dict(), "accs": accs,
            "spread": float(spread)}


@pytest.fixture(scope="module")
def runs(one_thread):
    """The JAX init carried to the port; the JAX sharded loss, gradients
    and step; the port's one-process step and its 2-rank step."""
    x = _episodes()
    jm = JDKT(jbb.ConvNetS(depth=2), WAY, SHOT, "bncossim",
              feature_dtype="float32")
    jstate = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    jmesh = jpar.make_mesh(2)
    grad_fn = jax.jit(jax.value_and_grad(jm.batch_loss),
                      in_shardings=(jpar.replicated(jmesh),
                                    jpar.episode_sharding(jmesh)),
                      out_shardings=(jpar.replicated(jmesh),
                                     jpar.replicated(jmesh)))
    xs = jpar.shard_episode_batch(jnp.asarray(x), jmesh)
    jloss, jgrads = grad_fn(jpar.replicate_tree(jstate.params, jmesh), xs)
    _, jm_metrics = jpar.make_sharded_train_step(jm, jmesh)(
        jpar.replicate_tree(jstate, jmesh), xs)

    one = _model().init(torch.from_numpy(x[0]))
    dkt_params_from_jax(jax.tree.map(np.asarray, jstate.params), one, PX)
    state = {k: v.clone() for k, v in one.state_dict().items()}
    loss1 = float(one.train_step(torch.from_numpy(x))["loss"])
    grads1 = {n: p.grad.clone() for n, p in one.named_parameters()}
    jgrads = jax.tree.map(np.asarray, jgrads)
    return dict(
        x=x, state=state, loss1=loss1, grads1=grads1, one=one,
        two=spawn_ranks(2, "cpu", _sharded_step, x, state),
        jloss=float(jloss), jstep_loss=float(jm_metrics["loss"]),
        jgrads=dkt_state_from_jax({"feature": {"params":
                                               jgrads["feature"]["params"]},
                                   "gp": jgrads["gp"]}, one, PX))


def test_sharded_step_matches_one_process(runs):
    two = runs["two"]
    assert np.isfinite(two["loss"])
    np.testing.assert_allclose(two["loss"], runs["loss1"], rtol=1e-4)
    assert set(two["grads"]) == set(runs["grads1"])
    for name, want in runs["grads1"].items():
        np.testing.assert_allclose(two["grads"][name].numpy(), want.numpy(),
                                   rtol=5e-3, atol=1e-5, err_msg=name)
    # the running statistics merged from the ranks' averaged statistics
    for name, want in runs["one"].state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(two["state"][name].numpy(),
                                       want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_parameters_identical_on_both_ranks(runs):
    assert runs["two"]["spread"] == 0.0


def test_sharded_step_matches_jax_sharded_step(runs):
    two = runs["two"]
    np.testing.assert_allclose(two["loss"], runs["jloss"], rtol=1e-4)
    np.testing.assert_allclose(two["loss"], runs["jstep_loss"], rtol=1e-4)
    assert set(two["grads"]) == set(runs["jgrads"])
    for name, want in runs["jgrads"].items():
        np.testing.assert_allclose(two["grads"][name].numpy(), want,
                                   rtol=5e-3, atol=1e-5, err_msg=name)


def test_sharded_eval_matches_one_process(runs):
    model = _model().init(torch.from_numpy(runs["x"][0]))
    model.load_state_dict(runs["two"]["state"])
    want = model.batch_correct(torch.from_numpy(runs["x"])).numpy()
    got = runs["two"]["accs"].numpy()
    assert got.shape == (B,)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_wrap_pad_episodes_pads_to_the_episode_extent():
    mesh = Mesh(rank=0, size=4, device=CPU)
    for xb in (np.arange(15, dtype=np.float32).reshape(3, 5),
               torch.arange(15.0).reshape(3, 5)):
        padded, b = wrap_pad_episodes(xb, mesh)
        assert b == 3 and padded.shape[0] == 4
        np.testing.assert_array_equal(np.asarray(padded[3]),
                                      np.asarray(xb[0]))
    xb4 = torch.ones(4, 5)
    padded4, b4 = wrap_pad_episodes(xb4, mesh)
    assert b4 == 4 and padded4 is xb4
    assert wrap_pad_episodes(xb4, Mesh(0, 3, CPU))[0].shape[0] == 6
    with pytest.raises(ValueError, match="wrap_pad_episodes"):
        shard_episode_batch(torch.ones(3, 5), Mesh(1, 2, CPU))
    np.testing.assert_array_equal(
        shard_episode_batch(np.arange(4), Mesh(1, 2, CPU)).numpy(), [2, 3])
    local = distribute_local_episodes(np.ones((2, 3), np.float32),
                                      Mesh(1, 2, CPU))
    assert isinstance(local, torch.Tensor) and local.shape == (2, 3)


def test_make_mesh_refuses_overcommit_and_starts_one_rank():
    with pytest.raises(ValueError, match="devices available"):
        make_mesh(os.cpu_count() + 1, "cpu")
    with pytest.raises(RuntimeError, match="spawn_ranks or torchrun"):
        make_mesh(2, "cpu")
    assert not dist.is_initialized()
    mesh = make_mesh(1, "cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.shape) == (0, 1, {"dp": 1})
        t = [torch.tensor([3.0, 5.0]), torch.tensor([7.0], dtype=torch.float64)]
        average(t, mesh)  # one rank: the mean is the value
        assert t[0].tolist() == [3.0, 5.0] and t[1].tolist() == [7.0]
    finally:
        dist.destroy_process_group()


def test_mesh_size_rules():
    args = ["--method=DKT", "--dataset=omniglot", "--episode_batch=4"]
    dkt = _model()
    size = factory.mesh_size
    assert size(parse_args("train", args), dkt, 4, CPU) == 1  # CPU default
    assert size(parse_args("train", args + ["--n_devices=2"]), dkt, 4,
                CPU) == 2
    with pytest.raises(ValueError, match="--n_devices=3 needs a method"):
        size(parse_args("train", args + ["--n_devices=3"]), dkt, 4, CPU)
    base = BaselineTrain(ConvNet(2), 10, device="cpu")
    with pytest.raises(ValueError, match="batch_loss_train"):
        size(parse_args("train", args + ["--n_devices=2"]), base, 4, CPU)


def test_sharded_draws_are_the_full_batch_rows(tmp_path):
    """Each rank's episodes and augmentation are its rows of the
    one-process batch, padded rows wrapped."""
    rng = np.random.RandomState(3)
    names, labels = [], []
    for cl in range(4):
        for i in range(6):
            p = str(tmp_path / f"c{cl}_{i}.png")
            Image.fromarray((rng.rand(20, 20, 3) * 255).astype(
                np.uint8)).save(p)
            names.append(p)
            labels.append(cl)
    jf = str(tmp_path / "base.json")
    with open(jf, "w") as f:
        json.dump({"label_names": [f"c{i}" for i in range(4)],
                   "image_names": names, "image_labels": labels}, f)
    ds = DeviceDataset(jf, 16, canvas=True, device="cpu")
    for batch in (4, 3):
        full = ds.epoch(5, 2, 1, 2, batch, batch, augment_to=16)
        want = next(full).numpy()
        rows = np.arange(4) % batch
        for rank in (0, 1):
            part = ds.shard(Mesh(rank, 2, CPU)).epoch(
                5, 2, 1, 2, batch, batch, augment_to=16)
            np.testing.assert_array_equal(
                next(part).numpy(), want[rows[2 * rank:2 * rank + 2]])
    assert ds.mesh is None  # shard left the receiver as it was


@pytest.fixture(scope="module")
def omniglot_cwd(tmp_path_factory, one_thread):
    root = tmp_path_factory.mktemp("parallel_cli")
    img_dir = root / "filelists" / "omniglot" / "images"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    names, labels = [], []
    for cl in range(6):
        for i in range(12):
            arr = (rng.rand(28, 28, 3) * 120).astype(np.uint8)
            r, c = divmod(cl, 3)
            arr[r * 12:r * 12 + 10, c * 9:c * 9 + 8] += 20  # class signature
            p = img_dir / f"c{cl}_{i}.png"
            Image.fromarray(arr).save(p)
            names.append(str(p))
            labels.append(cl)
    meta = {"label_names": [f"c{i}" for i in range(6)],
            "image_names": names, "image_labels": labels}
    for split in ("base", "val", "novel"):
        with open(root / "filelists" / "omniglot" / f"{split}.json", "w") as f:
            json.dump(meta, f)
    old = os.getcwd()
    os.chdir(root)
    try:
        yield root
    finally:
        os.chdir(old)


CLI = ["--dataset=omniglot", "--model=Conv4", "--method=DKT",
       "--train_n_way=3", "--test_n_way=3", "--n_shot=2", "--seed=3",
       "--feature_dtype=float32", "--episode_batch=4"]


CKPT = "save/checkpoints/omniglot/Conv4S_DKT_3way_2shot"
TRAIN = CLI + ["--stop_epoch=3", "--n_train_episodes=4", "--device_data=on"]


def _epoch_losses(ckpt_dir: str) -> list:
    with open(f"{ckpt_dir}/log/metrics.jsonl") as f:
        return [json.loads(line)["epoch_loss"] for line in f]


@pytest.fixture(scope="module")
def one_rank(omniglot_cwd):
    """3 steps (3 epochs of one 4-episode batch) on device-staged splits
    in one process: the epoch losses; its checkpoints move aside."""
    ttrain.main(TRAIN, device="cpu")
    losses = _epoch_losses(CKPT)
    os.rename(CKPT, CKPT + "_one")
    return losses


def test_train_and_test_cli_on_two_ranks(one_rank, capsys):
    """The 2-rank losses are the 1-rank run's; rank 0 alone writes the
    logs, checkpoints and results line; the 2-rank test (host loader, 9
    episodes, the last batch padded) gives the 1-rank accuracy."""
    ttrain.main(TRAIN + ["--n_devices=2"], device="cpu")
    assert "episode-parallel mesh: {'dp': 2}" in capsys.readouterr().out
    two = _epoch_losses(CKPT)
    assert len(two) == 3  # one line an epoch: rank 0's
    np.testing.assert_allclose(two, one_rank, rtol=1e-4)
    assert sorted(os.listdir(CKPT)) == sorted(os.listdir(CKPT + "_one"))

    test = CLI + ["--n_iter=9", "--repeat=1", "--device_data=off"]
    acc1 = ttest.main(test, device="cpu")
    acc2 = ttest.main(test + ["--n_devices=2"], device="cpu")
    np.testing.assert_allclose(acc2, acc1, atol=1e-4)
    with open("record/results.txt") as f:
        assert len(f.read().splitlines()) == 2
    shutil.rmtree(CKPT)


def test_train_cli_under_torchrun(one_rank, tmp_path):
    """Two processes started by torchrun join its env:// group: the
    1-rank run's losses again."""
    script = tmp_path / "rank.py"
    script.write_text(
        f"import sys\nsys.path.insert(0, {REPO!r})\n"
        f"from deep_kernel_transfer_tpu_torch import train\n"
        f"train.main({TRAIN + ['--n_devices=2']!r}, device='cpu')\n")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         f"--master_port={free_port()}", str(script)],
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("episode-parallel mesh: {'dp': 2}") == 1
    np.testing.assert_allclose(_epoch_losses(CKPT), one_rank, rtol=1e-4)
    shutil.rmtree(CKPT)
