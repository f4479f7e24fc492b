"""The port's regression CLIs and sines scripts end to end on the CPU:

  * `train_regression.main(..., device="cpu")` for 2 epochs on a generated
    QMUL grid (all 29 people, the pitches 60-120 a trajectory reaches, 19
    angles, 100-px JPEGs whose brightness follows the pitch), for DKT rbf,
    DKT --spectral and transfer, then `test_regression.main`;
  * the JAX package's root test_regression.py on the port's checkpoint in
    the same cwd with the same seed: the same mean MSE within 1e-4
    relative. For --spectral the JAX kernel's sq_dist is replaced by the
    exact elementwise sum (tests/test_torch_regression.py says why); with
    its own |a|^2 + |b|^2 - 2 a.b the JAX MSE moves by about 1e-3 and is
    held within 1e-2;
  * the checkpoint's reference layout, read back by the JAX importer to
    the port's parameters, ARD vectors and transfer head permuted;
  * a JAX npz checkpoint read by the port; --resume; the --task_batch
    rule; the three sines scripts through `main([...])`.

Both packages decode through PIL (their native decoders are switched
off).
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from deep_kernel_transfer_tpu import native as jnative
from deep_kernel_transfer_tpu_torch import native as tnative
from deep_kernel_transfer_tpu.gp import kernels as jkernels
from deep_kernel_transfer_tpu.utils import checkpoint as jckpt
from deep_kernel_transfer_tpu.utils import torch_import as jimport
from deep_kernel_transfer_tpu_torch import test_regression as ttest
from deep_kernel_transfer_tpu_torch import train_regression as ttrain
from deep_kernel_transfer_tpu_torch.data import qmul as tqmul
from deep_kernel_transfer_tpu_torch.io_utils import parse_args_regression
from deep_kernel_transfer_tpu_torch.utils.convert import state_from_jax
from torch_test_threads import one_thread  # noqa: F401

FLAGS = {"rbf": ["--method=DKT"], "spectral": ["--method=DKT", "--spectral"],
         "transfer": ["--method=transfer"]}
CKPT = {"rbf": "Conv3_DKT", "spectral": "Conv3_DKT_spectral",
        "transfer": "Conv3_transfer"}
TEST = ["--seed=3", "--n_test_epochs=4", "--n_support=5"]


def _exact_sq_dist(x1, x2):
    import jax.numpy as jnp

    return jnp.sum(jnp.square(x1[:, None, :] - x2[None, :, :]), axis=-1)


@pytest.fixture(scope="module")
def qmul_cwd(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_qmul")
    img_dir = str(root / "filelists" / "QMUL" / "images")
    rng = np.random.RandomState(0)
    for person in tqmul.train_people + tqmul.test_people:
        os.makedirs(os.path.join(img_dir, person))
        for pitch in range(60, 130, 10):
            for angle in range(0, 190, 10):
                arr = np.full((100, 100, 3), int(pitch * 255 / 130), np.uint8)
                arr[:, :angle // 2] //= 2
                arr += (rng.rand(100, 100, 3) * 20).astype(np.uint8)
                Image.fromarray(arr).save(
                    tqmul.face_file(img_dir, person, pitch, angle))
    old = os.getcwd()
    os.chdir(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        yield root
    os.chdir(old)


@pytest.fixture(scope="module")
def trained(qmul_cwd):
    """kind -> (the port's model after 2 epochs, its printed losses)."""
    out = {}
    for kind, flags in FLAGS.items():
        model = ttrain.main(flags + ["--seed=1", "--stop_epoch=2"], "cpu")
        out[kind] = model
    return out


def _ckpt(kind):
    return os.path.join("save", "checkpoints", "QMUL", CKPT[kind],
                        "best_model.tar")


@pytest.mark.parametrize("kind", ["rbf", "spectral", "transfer"])
def test_jax_test_regression_reads_port_checkpoint(kind, trained,
                                                   monkeypatch):
    import test_regression as jtest

    blob = torch.load(_ckpt(kind), weights_only=True)
    assert blob["epoch"] == 1
    parts = ({"feature_extractor", "model"} if kind == "transfer"
             else {"gp", "likelihood", "net"})
    assert set(blob) == parts | {"epoch"}
    assert trained[kind].step == (2 if kind == "transfer" else 48)
    mse, std = ttest.main(FLAGS[kind] + TEST, "cpu")
    assert np.isfinite(mse) and np.isfinite(std) and mse > 0
    if kind == "spectral":
        rough, _ = jtest.main(FLAGS[kind] + TEST)
        assert abs(rough - mse) < 1e-2 * mse
        monkeypatch.setattr(jkernels, "sq_dist", _exact_sq_dist)
    want, want_std = jtest.main(FLAGS[kind] + TEST)
    assert abs(mse - want) < 1e-4 * want
    assert abs(std - want_std) < 1e-3 * want_std


@pytest.mark.parametrize("kind", ["spectral", "transfer"])
def test_reference_layout_through_the_jax_importer(kind, trained):
    """The JAX importer reads the port's checkpoint to the port's own
    parameters: the spectral ARD vectors [4, 1, 2916] and the transfer
    head [1, 2916] in CHW order, the noise under gpytorch's
    GreaterThan(1e-4)."""
    import train_regression as jtrain

    params = parse_args_regression("train_regression", FLAGS[kind])
    jm = jtrain.build_regression_method(params)
    example = jax.numpy.zeros((19, 100, 100, 3))
    jparams = jm.init(jax.random.PRNGKey(0), example).params
    state, _ = jimport.load_torch_state(_ckpt(kind))
    if kind == "transfer":
        assert state["model.layer4.weight"].shape == (1, 2916)
        imported = jimport.import_feature_transfer(state, jm, jparams, 100)
    else:
        assert state["gp.covar_module.raw_mixture_means"].shape == (4, 1,
                                                                    2916)
        imported = jimport.import_dkt_regression(state, jm, jparams, 100)
    model = trained[kind]
    want = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    got = state_from_jax(jax.tree.map(np.asarray, imported), model, 100)
    assert set(got) == set(want)
    for name, value in got.items():
        assert np.allclose(value, want[name], rtol=1e-5, atol=1e-6), name


def test_port_reads_jax_npz_checkpoint(qmul_cwd, monkeypatch):
    """A JAX npz best_model.tar (DKT --spectral, fresh weights) read by the
    port's test_regression: the JAX CLI's MSE (exact sq_dist, as above)."""
    import test_regression as jtest
    import train_regression as jtrain

    monkeypatch.setattr(jkernels, "sq_dist", _exact_sq_dist)
    flags = FLAGS["spectral"] + ["--dataset=npz"]
    params = parse_args_regression("train_regression", flags)
    jm = jtrain.build_regression_method(params)
    state = jm.init(jax.random.PRNGKey(5), jax.numpy.zeros((19, 100, 100,
                                                            3)))
    path = os.path.join("save", "checkpoints", "npz", "Conv3_DKT_spectral",
                        "best_model.tar")
    jckpt.save_checkpoint(path, state.params, 7)
    want, _ = jtest.main(flags + TEST)
    got, _ = ttest.main(flags + TEST, "cpu")
    assert abs(got - want) < 1e-4 * want


def test_resume_and_task_batch(trained, capsys):
    """--resume continues after the checkpoint's epoch, drawing the epochs'
    own trajectories; --task_batch=1 takes 24 steps an epoch, any other
    value one step on the mean over the 24 people."""
    model = ttrain.main(FLAGS["rbf"] + ["--seed=1", "--stop_epoch=3",
                                        "--resume"], "cpu")
    out = capsys.readouterr().out
    assert "(epoch 1)" in out and "[002]" in out and "[001]" not in out
    assert model.step == 24
    assert torch.load(_ckpt("rbf"), weights_only=True)["epoch"] == 2
    batched = ttrain.main(FLAGS["rbf"] + ["--seed=1", "--stop_epoch=1",
                                          "--task_batch=8",
                                          "--dataset=batched"], "cpu")
    assert batched.step == 1


@pytest.mark.parametrize("script", ["train_DKT", "train_FT", "train_MAML"])
def test_sines_scripts(script, tmp_path, monkeypatch):
    import importlib

    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(
        f"deep_kernel_transfer_tpu_torch.sines.{script}")
    args = ["--iterations=30", "--n_test_tasks=3", "--seed=1"]
    if script == "train_MAML":
        args += ["--task_batch=4", "--analysis=2"]
    mses = mod.main(args, device="cpu")
    assert len(mses) == 3 and all(np.isfinite(m) and m >= 0 for m in mses)
    if script == "train_MAML":
        assert os.path.isfile("plots/MAML_adaptation_curve.png")
        assert os.path.isfile("plots/MAML_sampled_steps.png")
