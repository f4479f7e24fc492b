"""The port's CLIs (deep_kernel_transfer_tpu_torch.train / .test) end to end
on a generated omniglot-layout dataset (28 px, Conv4 -> Conv4S, as
tests/test_cli_end_to_end.py builds it, with a faint class signature so
that accuracies stay short of 100%), on the CPU:

  * training with --device_data on and off, checkpoints in the
    reference's torch layout, the GP telemetry in log/metrics.jsonl, and
    --resume from the latest epoch;
  * the JAX package's test.py on a port-trained checkpoint gives the port
    test's accuracy on the same episodes (host loader, f32 trunk), and its
    logits on one batch agree within 1e-4;
  * a JAX npz checkpoint loaded by the port: batch_logits within 1e-4 of
    the JAX ones; train_telemetry against the JAX one on the same weights
    and episodes (accuracies equal, features within 1e-5);
  * a CUB-layout 84-px run with --train_aug --device_data on;
  * the device-data path with PIL unimportable, on staged splits.

Both packages decode through PIL: their native decoders are switched off
(`native.available -> False` in each), so the two decode alike.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu import native as jnative
from deep_kernel_transfer_tpu_torch import native as tnative
from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu.utils import checkpoint as jckpt
from deep_kernel_transfer_tpu_torch import test as ttest
from deep_kernel_transfer_tpu_torch import train as ttrain
from deep_kernel_transfer_tpu_torch.data.device_dataset import DeviceDataset
from deep_kernel_transfer_tpu_torch.data.filelist import EpisodicDataLoader
from deep_kernel_transfer_tpu_torch.methods import DKT
from deep_kernel_transfer_tpu_torch.models import Conv4S
from deep_kernel_transfer_tpu_torch.utils.checkpoint import load_checkpoint
from torch_test_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASSES, N_IMG = 6, 20
COMMON = ["--dataset=omniglot", "--model=Conv4", "--method=DKT",
          "--train_n_way=3", "--test_n_way=3", "--seed=1"]
CKPT = "./save/checkpoints/omniglot/Conv4S_DKT_3way_{}shot"


@pytest.fixture(scope="module")
def dataset_cwd(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cli")
    img_dir = root / "filelists" / "omniglot" / "images"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    names, labels = [], []
    for cl in range(N_CLASSES):
        for i in range(N_IMG):
            arr = (rng.rand(28, 28, 3) * 120).astype(np.uint8)
            r, c = divmod(cl, 3)
            arr[r * 12:r * 12 + 10, c * 9:c * 9 + 8] += 20  # class signature
            p = img_dir / f"c{cl}_{i}.jpg"
            Image.fromarray(arr).save(p)
            names.append(str(p))
            labels.append(cl)
    meta = {"label_names": [f"c{i}" for i in range(N_CLASSES)],
            "image_names": names, "image_labels": labels}
    (root / "filelists" / "CUB").mkdir(parents=True)
    for split in ("base", "val", "novel"):
        for ds in ("omniglot", "CUB"):
            with open(root / "filelists" / ds / f"{split}.json", "w") as f:
                json.dump(meta, f)
    old = os.getcwd()
    os.chdir(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        mp.delenv("DKT_NO_STAGE_CACHE", raising=False)
        yield root
    os.chdir(old)


def _train(shot, *extra):
    ttrain.main(COMMON + [f"--n_shot={shot}", "--stop_epoch=1",
                          "--n_train_episodes=10", *extra], device="cpu")
    return CKPT.format(shot)


@pytest.fixture(scope="module")
def trained_off(dataset_cwd):
    return _train(2, "--device_data=off")


@pytest.fixture(scope="module")
def trained_on(dataset_cwd):
    return _train(3, "--device_data=on", "--episode_batch=4")


@pytest.mark.parametrize("mode", ["off", "on"])
def test_train_checkpoints_and_telemetry(mode, trained_off, trained_on):
    ckpt_dir = trained_off if mode == "off" else trained_on
    assert sorted(os.listdir(ckpt_dir)) == ["0.tar", "best_model.tar", "log"]
    blob = torch.load(f"{ckpt_dir}/best_model.tar", weights_only=True)
    assert blob["epoch"] == 0
    state = blob["state"]
    assert state["feature.trunk.0.C.weight"].shape == (64, 1, 3, 3)
    assert state["feature.trunk.bn_out.running_var"].shape == (64,)
    for w in range(3):
        p = f"model.models.{w}."
        assert state[p + "mean_module.constant"].shape == (1,)
        assert state[p + "covar_module.raw_outputscale"].shape == ()
    assert not any(k.startswith("gp.") for k in state)
    records = [json.loads(line) for line in open(f"{ckpt_dir}/log/metrics.jsonl")]
    if mode == "off":  # 10 one-episode batches: one print boundary
        keys = set().union(*records)
        assert {"GP_support_accuracy", "GP_query_accuracy",
                "z_support/mean", "z_support/std"} <= keys
    assert any("test_accuracy" in r for r in records)


def test_resume_takes_the_latest_epoch(trained_on, capsys):
    ttrain.main(COMMON + ["--n_shot=3", "--stop_epoch=2",
                          "--n_train_episodes=4", "--episode_batch=4",
                          "--device_data=on", "--resume"], device="cpu")
    out = capsys.readouterr().out
    assert f"resumed from {trained_on}/0.tar (epoch 0)" in out
    assert os.path.isfile(f"{trained_on}/1.tar")
    assert "Epoch 0 |" not in out


def test_jax_test_cli_reads_the_port_checkpoint(trained_off):
    """The same episodes (host loader, same seed), the same weights, an f32
    trunk: the JAX test.py prints the port test's accuracy."""
    import test as jtest

    args = COMMON + ["--n_shot=2", "--device_data=off",
                     "--feature_dtype=float32", "--repeat=1", "--n_iter=10"]
    got = ttest.main(args, device="cpu")
    want = jtest.main(args)
    assert 30.0 < got[0] < 100.0
    assert abs(got[0] - want[0]) < 1e-4 and abs(got[1] - want[1]) < 1e-4
    lines = open("record/results.txt").read().splitlines()
    assert lines[-2].split(", Setting: ")[1] == lines[-1].split(
        ", Setting: ")[1] == ("omniglot-Conv4S-DKT 2shot 3way_test, Acc: 1 "
                              f"Test Acc = {want[0]:.2f}% +- {want[1]:.2f}%")

    # and the logits of one batch, through the JAX package's importer
    xb = next(iter(EpisodicDataLoader(
        "filelists/omniglot/novel.json", 28, 3, 2, 15, n_episodes=2,
        episode_batch=2, seed=4)))
    jm = JDKT(jbb.Conv4S(), 3, 2, feature_dtype="float32")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(xb[0])).params
    params, epoch = jckpt.load_params_checkpoint(
        f"{trained_off}/best_model.tar", params, method_name="DKT", model=jm,
        image_size=28)
    assert epoch == 0
    tm = DKT(Conv4S(), 3, 2, feature_dtype="float32", device="cpu").init(
        torch.from_numpy(xb[0]))
    load_checkpoint(f"{trained_off}/best_model.tar", tm, 28)
    with torch.no_grad():
        got = tm.batch_logits(torch.from_numpy(xb)).numpy()
    want = np.asarray(jm.batch_logits(params, jnp.asarray(xb)))
    assert np.abs(got - want).max() < 1e-4


@pytest.fixture(scope="module")
def jax_trained(dataset_cwd, tmp_path_factory):
    """A JAX DKT (Conv4S, bncossim) after one train step, its npz
    checkpoint, and episodes of the dataset."""
    xb = next(iter(EpisodicDataLoader(
        "filelists/omniglot/base.json", 28, 3, 2, 4, n_episodes=3,
        episode_batch=3, seed=2)))
    jm = JDKT(jbb.Conv4S(), 3, 2, feature_dtype="float32")
    state = jm.init(jax.random.PRNGKey(3), jnp.asarray(xb[0]))
    state, _ = jm.train_step(state, jnp.asarray(xb))
    path = str(tmp_path_factory.mktemp("npz") / "7.tar")
    jckpt.save_checkpoint(path, state.params, epoch=7)
    tm = DKT(Conv4S(), 3, 2, feature_dtype="float32", device="cpu").init(
        torch.from_numpy(xb[0]))
    assert load_checkpoint(path, tm, 28) == 7
    return jm, state.params, tm, xb


def test_jax_npz_checkpoint_in_the_port(jax_trained):
    jm, params, tm, xb = jax_trained
    with torch.no_grad():
        got = tm.batch_logits(torch.from_numpy(xb)).numpy()
    want = np.asarray(jm.batch_logits(params, jnp.asarray(xb)))
    assert got.shape == want.shape == (3, 3 * 4, 3)
    assert np.abs(got - want).max() < 1e-4


def test_train_telemetry_matches_jax(jax_trained):
    jm, params, tm, xb = jax_trained
    want = jm.train_telemetry(params, jnp.asarray(xb))
    got = tm.train_telemetry(torch.from_numpy(xb))
    for k in ("GP_support_accuracy", "GP_query_accuracy"):
        assert abs(float(got[k]) - float(want[k])) < 1e-4, k
    assert got["z_support"].shape == (3 * 2, 64)
    assert np.abs(got["z_support"].numpy()
                  - np.asarray(want["z_support"])).max() < 1e-5


def test_cub_train_aug_on_the_device(dataset_cwd):
    """84 px from canvases: staged at 96 px and augmented down on the
    device."""
    args = ["--dataset=CUB", "--model=Conv4", "--method=DKT",
            "--train_n_way=3", "--test_n_way=3", "--n_shot=1", "--seed=1",
            "--train_aug", "--device_data=on"]
    model = ttrain.main(args + ["--stop_epoch=1", "--n_train_episodes=2"],
                        device="cpu")
    assert os.path.isfile("save/checkpoints/CUB/Conv4_DKT_aug_3way_1shot/"
                          "best_model.tar")
    assert os.path.isfile("filelists/CUB/base.json.stage84c.npy")
    assert model.feature.out_dim(84, 84) == 1600


def test_device_path_runs_without_pil(trained_on):
    """With PIL unimportable, every module of the port imports, and train
    and test run on the device-data path from the staged splits."""
    DeviceDataset("filelists/omniglot/novel.json", 28, device="cpu")
    code = f"""
import importlib, pkgutil, sys
sys.modules["PIL"] = None
sys.path.insert(0, {REPO!r})
import deep_kernel_transfer_tpu_torch as port
for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(mod.name)
from deep_kernel_transfer_tpu_torch import test, train
args = {COMMON!r} + ["--n_shot=3", "--device_data=on"]
train.main(args + ["--stop_epoch=3", "--n_train_episodes=4",
                   "--episode_batch=4", "--resume"], device="cpu")
acc, _ = test.main(args + ["--n_iter=8", "--repeat=1", "--episode_batch=4"],
                   device="cpu")
assert 0.0 <= acc <= 100.0
print("NO_PIL_OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "NO_PIL_OK" in out.stdout, out.stderr


def test_chip_smoke_dataset_is_what_staging_decodes(tmp_path, monkeypatch):
    """chip_smoke.py's CLI phase writes its PNGs with a stdlib writer and
    its stage caches beforehand, so that the card needs no decoder: each
    PNG decodes to its class image, and each cache holds exactly what
    DeviceDataset stages from the PNGs."""
    import chip_smoke

    monkeypatch.delenv("DKT_NO_STAGE_CACHE", raising=False)
    files = chip_smoke.write_cli_dataset(
        str(tmp_path), splits=(("base", 2), ("val", 1), ("novel", 2)),
        n_images=3)
    meta = json.load(open(files["novel"]))
    assert meta["image_labels"] == [3, 3, 3, 4, 4, 4]
    img = np.asarray(Image.open(meta["image_names"][4]))
    assert np.array_equal(img, chip_smoke.class_images(4, 3)[1])
    for split, canvas in (("base", True), ("novel", False)):
        cached = DeviceDataset(files[split], 84, canvas=canvas, device="cpu")
        assert cached.from_cache
        monkeypatch.setenv("DKT_NO_STAGE_CACHE", "1")
        decoded = DeviceDataset(files[split], 84, canvas=canvas, device="cpu")
        monkeypatch.delenv("DKT_NO_STAGE_CACHE")
        assert not decoded.from_cache
        assert torch.equal(cached.images, decoded.images)
