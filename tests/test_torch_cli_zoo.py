"""The port's CLIs for the comparison methods, end to end on the CPU, on a
generated omniglot-layout dataset (28 px, Conv4 -> Conv4S, a faint class
signature, as tests/test_torch_cli.py builds it):

  * protonet: `train` -> `save_features` -> `test`; the JAX package's
    test.py reads the port's checkpoint and feature cache and prints the
    same accuracy (the episodes come from the same numpy draws and the
    scores are deterministic), and its test_uncertainty.py gives the same
    ECEs as the port's;
  * baseline++: `train` (5 epochs of flat minibatches, the last model
    kept) ->
    `save_features` -> `test`; the JAX test.py reads the port's cache. Its
    finetuned heads draw from jax.random and the port's from a
    torch.Generator, so only the accuracies' range is compared;
  * matchingnet (its LSTMs in the reference layout), relationnet (NP
    trunk, maps cached NHWC) and maml (episodes of n_task, scored from
    images): the JAX test.py on the port's checkpoint and cache gives the
    port's accuracy; their --adaptation runs (the linear-probe finetune,
    the relation-module finetune, 100 inner steps);
  * the port's test reads a cache that the JAX save_features.py wrote;
  * --warmup starts a method's trunk from the baseline's checkpoint.
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from deep_kernel_transfer_tpu import native as jnative
from deep_kernel_transfer_tpu_torch import native as tnative
from deep_kernel_transfer_tpu_torch import save_features as tsave
from deep_kernel_transfer_tpu_torch import test as ttest
from deep_kernel_transfer_tpu_torch import test_uncertainty as tunc
from deep_kernel_transfer_tpu_torch import train as ttrain
from deep_kernel_transfer_tpu_torch.data.feature_cache import init_loader
from torch_test_threads import one_thread  # noqa: F401

N_CLASSES, N_IMG = 6, 20
COMMON = ["--dataset=omniglot", "--model=Conv4", "--train_n_way=3",
          "--test_n_way=3", "--n_shot=2", "--seed=1", "--device_data=off"]
TEST = ["--repeat=1", "--n_iter=20"]
BASELINE = ["--num_classes=4112", "--stop_epoch=5"]


@pytest.fixture(scope="module")
def dataset_cwd(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cli_zoo")
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
    for split in ("base", "val", "novel"):
        with open(root / "filelists" / "omniglot" / f"{split}.json", "w") as f:
            json.dump(meta, f)
    old = os.getcwd()
    os.chdir(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        yield root
    os.chdir(old)


@pytest.fixture(scope="module")
def protonet(dataset_cwd):
    args = COMMON + ["--method=protonet"]
    ttrain.main(args + ["--stop_epoch=1", "--n_train_episodes=10"],
                device="cpu")
    return args, tsave.main(args, device="cpu")


@pytest.fixture(scope="module")
def baseline_pp(dataset_cwd):
    args = COMMON + ["--method=baseline++"]
    ttrain.main(args + BASELINE, device="cpu")
    return args, tsave.main(args, device="cpu")


def test_protonet_cache_and_jax_test_reads_it(protonet):
    import test as jtest

    args, cache = protonet
    ckpt = "save/checkpoints/omniglot/Conv4S_protonet_3way_2shot"
    assert sorted(os.listdir(ckpt)) == ["0.tar", "best_model.tar", "log"]
    state = torch.load(f"{ckpt}/best_model.tar", weights_only=True)["state"]
    assert state["feature.trunk.0.C.weight"].shape == (64, 1, 3, 3)
    assert cache == "./save/features/omniglot/Conv4S_protonet_3way_2shot/" \
                    "novel.hdf5"
    cl_data = init_loader(cache)
    assert sorted(cl_data) == list(range(N_CLASSES))
    assert all(len(v) == N_IMG and v[0].shape == (64,)
               for v in cl_data.values())
    got = ttest.main(args + TEST, device="cpu")
    want = jtest.main(args + TEST)
    assert 40.0 < got[0] <= 100.0
    assert abs(got[0] - want[0]) < 1e-4 and abs(got[1] - want[1]) < 1e-4


def test_protonet_calibration_matches_jax(protonet):
    import test_uncertainty as junc

    args = protonet[0] + ["--repeat=1", "--n_iter=10", "--episode_batch=4"]
    got = tunc.main(args, device="cpu")
    want = junc.main(args)
    for k in ("ece_raw", "ece_cal", "acc"):
        assert abs(got[k] - want[k]) < 1e-3, k


def test_baseline_pp_train_cache_and_test(baseline_pp):
    import test as jtest

    args, cache = baseline_pp
    ckpt = "save/checkpoints/omniglot/Conv4S_baseline++"
    assert sorted(os.listdir(ckpt)) == ["0.tar", "4.tar", "best_model.tar"]
    state = torch.load(f"{ckpt}/best_model.tar", weights_only=True)["state"]
    assert state["classifier.L.weight_v"].shape == (4112, 64)
    assert state["classifier.L.weight_g"].shape == (4112, 1)
    assert cache.endswith("features/omniglot/Conv4S_baseline++/novel.hdf5")
    got = ttest.main(args + TEST, device="cpu")[0]
    want = jtest.main(args + TEST)[0]
    assert 60.0 < got <= 100.0 and 60.0 < want <= 100.0
    assert abs(got - want) < 10.0


def test_port_test_reads_a_jax_cache(protonet, tmp_path):
    """The JAX save_features.py on the port's protonet checkpoint writes a
    cache the port's test reads, with the accuracy of the port's own."""
    import save_features as jsave

    args = protonet[0]
    jsave.main(args)  # overwrites the port's cache with the JAX one
    assert abs(ttest.main(args + TEST, device="cpu")[0]
               - ttest.main(args + TEST, device="cpu")[0]) == 0.0
    got = ttest.main(args + TEST, device="cpu")[0]
    tsave.main(args, device="cpu")
    assert abs(got - ttest.main(args + TEST, device="cpu")[0]) < 1e-4


def test_warmup_loads_the_baseline_trunk(dataset_cwd, capsys):
    ttrain.main(COMMON + ["--method=baseline"] + BASELINE, device="cpu")
    state = torch.load("save/checkpoints/omniglot/Conv4S_baseline/"
                       "best_model.tar", weights_only=True)["state"]
    model = ttrain.main(COMMON + ["--method=protonet", "--warmup",
                                  "--stop_epoch=0"], device="cpu")
    assert ("loaded 24 trunk entries from ./save/checkpoints/omniglot/"
            "Conv4S_baseline/best_model.tar") in capsys.readouterr().out
    own = model.feature.state_dict()
    assert len(own) == 24
    for k, v in own.items():
        assert torch.equal(v, state[f"feature.{k}"]), k


@pytest.mark.parametrize("method", ["matchingnet", "relationnet", "maml"])
def test_jax_test_reads_the_port_checkpoint(dataset_cwd, method):
    import test as jtest

    args = COMMON + [f"--method={method}", "--feature_dtype=float32"]
    ttrain.main(args + ["--stop_epoch=1", "--n_train_episodes=4"],
                device="cpu")
    if method != "maml":
        cache = tsave.main(args, device="cpu")
        shape = (5, 5, 64) if method == "relationnet" else (64,)
        assert next(iter(init_loader(cache).values()))[0].shape == shape
    got = ttest.main(args + TEST, device="cpu")
    want = jtest.main(args + TEST)
    assert 33.0 < got[0] <= 100.0
    assert abs(got[0] - want[0]) < 1e-4 and abs(got[1] - want[1]) < 1e-4
    adapted = ttest.main(args + ["--repeat=1", "--n_iter=2", "--adaptation"],
                         device="cpu")[0]
    assert 0.0 <= adapted <= 100.0


def test_digits_runner_ece_takes_a_comparator(dataset_cwd, tmp_path):
    """The digits runner's --ece runs the calibration study for a method
    other than DKT: protonet trained (one epoch of 10 episodes), its
    features cached and tested on this module's image set (5-way 5-shot),
    then test_uncertainty from the
    cache, with the rows under the JAX key names of
    benchmarks/calibration.py; the JAX test_uncertainty.py on the port's
    checkpoint and cache gives the same ECEs."""
    import argparse

    import test_uncertainty as junc

    from deep_kernel_transfer_tpu_torch.benchmarks import digits_real as tdr

    args = argparse.Namespace(epochs=1, repeat=1, n_iter=10,
                              dkt_variants=False, ece=True)
    short_train = argparse.Namespace(main=lambda argv, device: ttrain.main(
        argv + ["--n_train_episodes=10"], device=device))
    rows: dict = {}
    tdr._run_method("protonet", 5, "digits_real_protonet_5way_5shot",
                    "digits_real", args, "cpu", "cpu", set(), rows.update,
                    short_train, tsave, ttest, tunc)
    key = "digits_real_ece_protonet_5shot"
    names = ("raw", "raw_std", "cal", "cal_std", "temp", "acc")
    assert {f"{key}_{n}" for n in names} <= set(rows)
    assert 0.0 <= rows[f"{key}_raw"] <= 1.0 and rows[f"{key}_temp"] > 0
    assert "digits_real_protonet_5way_5shot_acc" in rows
    assert os.path.isfile("save/features/omniglot/"
                          "Conv4S_protonet_5way_5shot/novel.hdf5")
    want = junc.main(["--dataset=omniglot", "--model=Conv4",
                      "--train_n_way=5", "--test_n_way=5", "--n_shot=5",
                      "--seed=1", "--method=protonet", "--repeat=1",
                      "--n_iter=10", "--episode_batch=32"])
    for k, n in (("ece_raw", "raw"), ("ece_cal", "cal"), ("acc", "acc")):
        assert abs(rows[f"{key}_{n}"] - want[k]) < 1e-3, k
