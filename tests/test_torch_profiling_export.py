"""The port's profiling helpers (utils/profiling.py, the counterparts of
tests/test_profiling.py) and its export CLI (export_checkpoint.py) against
the JAX package's root export_checkpoint.py.

Both export CLIs read the same JAX npz checkpoint (DKT on Conv4S, and
--regression DKT spectral on Conv3) and write the reference layout: the
files must hold the same keys with values within 1e-6 (the port's
regression file adds its 'epoch', which the reference's regression layout
lacks), and the port's load_checkpoint reads its file back. Torch is held
to one thread.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu.utils import checkpoint as jckpt
from deep_kernel_transfer_tpu_torch import export_checkpoint as texport
from deep_kernel_transfer_tpu_torch.io_utils import parse_args_regression
from deep_kernel_transfer_tpu_torch.methods import DKT
from deep_kernel_transfer_tpu_torch.models import Conv4S
from deep_kernel_transfer_tpu_torch.train_regression import (
    init_regression_method)
from deep_kernel_transfer_tpu_torch.utils.checkpoint import load_checkpoint
from deep_kernel_transfer_tpu_torch.utils.profiling import annotate, trace
from torch_test_threads import one_thread  # noqa: F401


def test_annotate_is_usable_as_context():
    with annotate("unit-test-span"):
        x = float(torch.zeros(()) + 1)
    assert x == 1.0


def test_trace_writes_a_trace_with_the_annotated_span(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir, "cpu") as prof:
        with annotate("traced-span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.listdir(log_dir)
    assert "dkt.traced-span" in {e.key for e in prof.key_averages()}


@pytest.fixture
def cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _same_files(a: str, b: str, extra=()) -> None:
    """The files at a and b hold the same keys (a also `extra`) with
    values within 1e-6."""
    got = torch.load(a, weights_only=True)
    want = torch.load(b, weights_only=True)

    def flat(blob, prefix=""):
        out = {}
        for k, v in blob.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = v
        return out

    got, want = flat(got), flat(want)
    assert sorted(got) == sorted([*want, *extra])
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.shape == w.shape, k
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
        else:
            assert g == w, k


def test_export_classification_matches_jax(cwd):
    import export_checkpoint as jexport

    x = np.random.RandomState(0).randint(0, 256, (3, 17, 28, 28, 3)).astype(
        np.uint8)
    jm = JDKT(jbb.Conv4S(), 3, 2, feature_dtype="float32")
    state = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))
    state, _ = jm.train_step(state, jnp.asarray(x[None]))
    ckpt_dir = "save/checkpoints/omniglot/Conv4S_DKT_3way_2shot"
    jckpt.save_checkpoint(f"{ckpt_dir}/best_model.tar", state.params,
                          epoch=4)
    args = ["--dataset=omniglot", "--model=Conv4", "--method=DKT",
            "--train_n_way=3", "--test_n_way=3", "--n_shot=2"]
    jexport.main(args + ["--out=jax.tar"])
    assert texport.main(args + ["--out=port.tar"], device="cpu") == "port.tar"
    _same_files("port.tar", "jax.tar")
    assert torch.load("port.tar", weights_only=True)["epoch"] == 4

    tm = DKT(Conv4S(), 3, 2, feature_dtype="float32", device="cpu").init(
        torch.from_numpy(x))
    assert load_checkpoint("port.tar", tm, 28) == 4
    with torch.no_grad():
        got = tm.batch_logits(torch.from_numpy(x[None])).numpy()
    want = np.asarray(jm.batch_logits(state.params, jnp.asarray(x[None])))
    assert np.abs(got - want).max() < 1e-4

    # the default name beside the checkpoint
    out = texport.main(args, device="cpu")
    assert out == f"./{ckpt_dir}/best_model.torch.tar"
    assert os.path.isfile(out)


def test_export_regression_spectral_matches_jax(cwd):
    import export_checkpoint as jexport
    from train_regression import build_regression_method

    args = ["--dataset=QMUL", "--model=Conv3", "--method=DKT", "--spectral"]
    jparams = parse_args_regression("test_regression", args)
    jm = build_regression_method(jparams)
    params = jm.init(jax.random.PRNGKey(2),
                     jnp.zeros((19, 100, 100, 3), jnp.float32)).params
    ckpt = "save/checkpoints/QMUL/Conv3_DKT_spectral/best_model.tar"
    jckpt.save_checkpoint(ckpt, params, epoch=9)
    jexport.main(["--regression", "--out=jax.tar"] + args)
    texport.main(["--regression", "--out=port.tar"] + args, device="cpu")
    # the port's regression files add the epoch, for --resume
    _same_files("port.tar", "jax.tar", extra=("epoch",))

    model = init_regression_method(jparams, "cpu")
    assert load_checkpoint("port.tar", model, 100) == 9
    again = init_regression_method(jparams, "cpu")
    load_checkpoint(ckpt, again, 100)
    # the noise goes through GreaterThan(1e-4) and back in f32
    for (name, a), b in zip(model.state_dict().items(),
                            again.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_export_without_a_checkpoint_exits(cwd):
    with pytest.raises(SystemExit, match="no checkpoint"):
        texport.main(["--dataset=omniglot", "--model=Conv4", "--method=DKT"],
                     device="cpu")
    with pytest.raises(SystemExit, match="no checkpoint"):
        texport.main(["--regression", "--method=transfer"], device="cpu")
