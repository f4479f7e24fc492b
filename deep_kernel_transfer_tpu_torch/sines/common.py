"""Shared harness of the sines experiments (port of sines_tpu/common.py).

Protocol (reference sines/train_DKT.py:146-230): train on tasks of
TaskDistribution(amplitude 0.1-5, phase 0-pi, x in [-5, 5], sine) with
N_SHOT_TRAIN = 10 noisy points a task; evaluate on 500 fresh tasks of 200
points each, conditioned on N_SHOT_TEST = 5 random support points;
--out_of_range widens the test x-range to (-5, 10). matplotlib is imported
only to draw plots (--n_plots, --analysis).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.sines import TaskDistribution

N_SHOT_TRAIN = 10
N_SHOT_TEST = 5
TRAIN_RANGE = (-5.0, 5.0)
SAMPLE_SIZE = 200


def parse_args(script: str, default_iters: int, argv=None,
               default_task_batch: int = 1):
    p = argparse.ArgumentParser(description=f"sines {script}")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--iterations", default=default_iters, type=int,
                   help="training iterations (reference: 50000)")
    p.add_argument("--task_batch", default=default_task_batch, type=int,
                   help="tasks per step; DKT/FT default 1 = the reference; "
                        "MAML defaults to 25 (the meta objective needs a "
                        "task batch; the reference uses 1000)")
    p.add_argument("--out_of_range", action="store_true",
                   help="test on x in (-5, +10) (reference test_range note)")
    p.add_argument("--n_test_tasks", default=500, type=int)
    p.add_argument("--n_plots", default=0, type=int,
                   help="save this many uncertainty-band plots")
    p.add_argument("--analysis", default=0, type=int, metavar="N_TASKS",
                   help="MAML only: average the adaptation curve over "
                        "N_TASKS tasks and plot sampled-step functions "
                        "(reference sines/train_MAML.py:206-330)")
    return p.parse_args(argv)


def train_tasks() -> TaskDistribution:
    return TaskDistribution(x_min=TRAIN_RANGE[0], x_max=TRAIN_RANGE[1])


def test_tasks(out_of_range: bool) -> TaskDistribution:
    hi = 10.0 if out_of_range else 5.0
    return TaskDistribution(x_min=TRAIN_RANGE[0], x_max=hi)


def sample_eval_task(rng: np.random.RandomState, tasks: TaskDistribution):
    """(task, x_support, y_support, x_query, y_query, x_all, y_all), numpy
    (reference sines/train_DKT.py:201-214)."""
    task = tasks.sample_task(rng)
    x_all, y_all = task.sample_data(rng, SAMPLE_SIZE, noise=0.1, sort=True)
    indices = np.arange(SAMPLE_SIZE)
    rng.shuffle(indices)
    s = np.sort(indices[:N_SHOT_TEST])
    q = np.sort(indices[N_SHOT_TEST:])
    return task, x_all[s], y_all[s], x_all[q], y_all[q], x_all, y_all


def report(name: str, mse_list) -> None:
    print("-------------------")
    print(f"[{name}] Average MSE: {np.mean(mse_list):.4f} "
          f"+- {np.std(mse_list):.4f}")
    print("-------------------")


def save_uncertainty_plot(i: int, name: str, task, x_support, y_support,
                          x_all, mean, lower=None, upper=None,
                          test_hi: float = 5.0) -> None:
    """plot_<name>_<i>.png in the layout of reference
    sines/train_DKT.py:233-277; mean, lower and upper as numpy arrays."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    grid = np.linspace(TRAIN_RANGE[0], TRAIN_RANGE[1], 1000)
    ax.plot(grid, [task.true_function(x) for x in grid], color="blue",
            linewidth=2.0)
    if TRAIN_RANGE[1] < test_hi:
        grid2 = np.linspace(TRAIN_RANGE[1], test_hi, 1000)
        ax.plot(grid2, [task.true_function(x) for x in grid2], color="blue",
                linestyle="--", linewidth=2.0)
    ax.plot(np.squeeze(x_all), mean, color="red", linewidth=2.0)
    if lower is not None:
        ax.fill_between(np.squeeze(x_all), lower, upper, alpha=0.1,
                        color="red")
    ax.scatter(np.squeeze(x_support), y_support, color="darkblue",
               marker="*", s=50, zorder=10)
    plt.ylim(-6.0, 6.0)
    plt.xlim(TRAIN_RANGE[0], test_hi)
    plt.savefig(f"plot_{name}_{i}.png", dpi=300)
    plt.close(fig)
