"""The port's synthetic QMUL grid against the JAX package's (ROADMAP C3).

The port's regression runner (`deep_kernel_transfer_tpu_torch/benchmarks/
regression_real.py`) keeps its own copy of the JAX `benchmarks/
paper_protocol.py` face renderer and grid writer. The test holds the copy
to the JAX one: the rendered faces equal, and the JPEG files of a few
people byte for byte equal on this machine's PIL.

Run as a script, the file is ROADMAP C3's procedure: both packages'
QMUL coverage runs (`regression_real.qmul_coverage`, the JAX
`benchmarks/coverage.py::qmul_coverage`, each through its own
`train_regression` CLI) on one grid, the port's, per seed and kernel,
each arm a process of its own with one thread; the JAX spectral kernel
also with its `sq_dist` as the exact elementwise sum, as
`tests/test_torch_regression.py` runs it:

    JAX_PLATFORMS=cpu python tests/test_torch_qmul_grid.py \\
        --seeds 1,2,3 --epochs 20 --root /path/to/workdir --out c3.json
"""
import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # for a run as a script

from deep_kernel_transfer_tpu_torch.benchmarks import regression_real  # noqa


def _jax_script(name: str):
    """A module of the JAX `benchmarks/` folder, loaded from its file (the
    folder's `coverage.py` would clash with the coverage package)."""
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    spec = importlib.util.spec_from_file_location(
        f"jax_benchmarks_{name}", os.path.join(REPO, "benchmarks",
                                               f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree_hash(root: str, people: list) -> str:
    """sha256 over the grid's JPEG files of `people`, in name order."""
    h = hashlib.sha256()
    img_dir = os.path.join(root, "filelists", "QMUL", "images")
    for person in people:
        d = os.path.join(img_dir, person)
        for name in sorted(os.listdir(d)):
            h.update(name.encode())
            with open(os.path.join(d, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()


@pytest.mark.parametrize("person,pitch,angle", [(0, 0, 0), (7, 60, 90),
                                                (28, 120, 180)])
def test_faces_equal_jax(person, pitch, angle):
    want = _jax_script("paper_protocol").render_face(person, pitch, angle)
    assert np.array_equal(regression_real.render_face(person, pitch, angle),
                          want)


def test_grid_files_equal_jax(tmp_path, monkeypatch):
    """Both packages' grid writers, cut to their first two people, write
    the same JPEG bytes."""
    from deep_kernel_transfer_tpu.data import qmul as jqmul
    from deep_kernel_transfer_tpu_torch.data import qmul as tqmul
    two = jqmul.train_people[:2]
    monkeypatch.setattr(jqmul, "train_people", two)
    monkeypatch.setattr(jqmul, "test_people", [])
    monkeypatch.setattr(tqmul, "train_people", two)
    monkeypatch.setattr(tqmul, "test_people", [])
    _jax_script("paper_protocol").make_synthetic_qmul(str(tmp_path / "jax"))
    regression_real.make_synthetic_qmul(str(tmp_path / "port"), threads=2)
    assert (_tree_hash(str(tmp_path / "jax"), two)
            == _tree_hash(str(tmp_path / "port"), two))


# -- ROADMAP C3's runs ------------------------------------------------------

def run_arm(arm: str, kernel: str, seed: int, epochs: int, n_test: int,
            root: str) -> dict:
    """One arm's (coverage95, MSE), trained in a working directory of its
    own beside the shared grid (the CLIs write ./save/)."""
    wd = os.path.join(root, f"{arm}_{kernel}_s{seed}")
    os.makedirs(wd, exist_ok=True)
    link = os.path.join(wd, "filelists")
    if not os.path.exists(link):
        os.symlink(os.path.join(root, "filelists"), link)
    t0 = time.perf_counter()
    if arm == "port":
        import torch
        torch.set_num_threads(1)
        os.chdir(wd)
        cov, mse = regression_real.qmul_coverage(seed, kernel, epochs, n_test,
                                                 "cpu")
    else:
        cov_mod = _jax_script("coverage")
        if arm == "jax_exact":
            import jax.numpy as jnp
            from deep_kernel_transfer_tpu.gp import kernels as jkernels
            jkernels.sq_dist = lambda x1, x2: jnp.sum(
                jnp.square(x1[:, None, :] - x2[None, :, :]), axis=-1)
        cov, mse = cov_mod.qmul_coverage(seed, kernel, epochs, wd, n_test)
    return {"arm": arm, "kernel": kernel, "seed": seed, "coverage95": cov,
            "mse": mse, "s": time.perf_counter() - t0}


def main(args) -> dict:
    root = os.path.abspath(args.root)
    os.makedirs(root, exist_ok=True)
    regression_real.make_synthetic_qmul(root)
    from deep_kernel_transfer_tpu_torch.data import qmul
    grid = _tree_hash(root, qmul.train_people + qmul.test_people)
    jobs = [(arm, kernel, seed) for kernel in args.kernels.split(",")
            for arm in ("port", "jax") + (("jax_exact",)
                                          if kernel == "spectral" else ())
            for seed in (int(s) for s in args.seeds.split(","))]
    env = dict(os.environ, JAX_PLATFORMS="cpu", DKT_NO_JIT_CACHE="1",
               OMP_NUM_THREADS="1", XLA_FLAGS="--xla_cpu_multi_thread_eigen="
               "false intra_op_parallelism_threads=1")

    def launch(job):
        arm, kernel, seed = job
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--arm", arm,
             "--kernels", kernel, "--seeds", str(seed), "--epochs",
             str(args.epochs), "--n_test", str(args.n_test), "--root", root],
            env=env, capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode or not lines:
            return {"arm": arm, "kernel": kernel, "seed": seed,
                    "error": out.stderr[-2000:]}
        return json.loads(lines[-1])

    with ThreadPoolExecutor(args.workers) as pool:
        rows = list(pool.map(launch, jobs))
    report = {"grid_sha256": grid, "epochs": args.epochs,
              "n_test": args.n_test, "rows": rows}
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--kernels", default="rbf,spectral")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--n_test", type=int, default=50)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--root", required=True)
    ap.add_argument("--arm", default=None,
                    help="one arm in this process: port, jax or jax_exact")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.arm:
        print(json.dumps(run_arm(a.arm, a.kernels, int(a.seeds), a.epochs,
                                 a.n_test, os.path.abspath(a.root))))
    else:
        main(a)
