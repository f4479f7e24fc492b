"""Sines MAML: second-order MAML on an MLP 1->40->40->1.

    python -m deep_kernel_transfer_tpu_torch.sines.train_MAML

Port of sines_tpu/train_MAML.py (reference sines/train_MAML.py:111-330):
one inner SGD step at 0.01 on a task's 10 points, the post-adaptation loss
on the same points, meta Adam at 1e-3 on its mean over a meta-batch of 25
tasks. The inner gradient and the second-order meta gradient come from
torch.func (grad of a vmap over tasks of grad), over the net's weights as
a dict. Evaluation (reference train_MAML.py:206-258): from the
meta-weights, Adam for n_steps on the 5 support points, MSE on the 195
query points of 500 tasks. --analysis averages the adaptation curve
(plain SGD, the query MSE after every step) over tasks and plots it.
`main(argv, device)` returns the test MSEs.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call, grad, grad_and_value, vmap

from .._device import resolve_device
from ..models.backbones import lecun_normal_
from ..utils.adam import Adam
from . import common

INNER_LR = 0.01
META_LR = 0.001
INNER_STEPS = 1


class MAMLModel(nn.Module):
    """reference sines/train_MAML.py:119-130: 1->40->40->1 ReLU MLP, with
    flax's Dense init (lecun_normal weights, zero biases)."""

    def __init__(self):
        super().__init__()
        self.layer1 = nn.Linear(1, 40)
        self.layer2 = nn.Linear(40, 40)
        self.layer3 = nn.Linear(40, 1)

    def reset_parameters(self, generator=None) -> None:
        for layer in (self.layer1, self.layer2, self.layer3):
            lecun_normal_(layer.weight, layer.weight.shape[1], generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.layer1(x))
        x = F.relu(self.layer2(x))
        return self.layer3(x)[..., 0]


class SinesMAML(nn.Module):
    """Build, then `init()`; the meta-weights live in `net`."""

    def __init__(self, meta_batch: int = 25, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.net = MAMLModel()
        self.meta_batch = meta_batch
        self.optimizer = None

    def init(self, generator=None) -> "SinesMAML":
        self.net.reset_parameters(generator)
        self.to(self.device)
        self.optimizer = Adam(list(self.net.parameters()), META_LR)
        return self

    def weights(self) -> dict:
        """The meta-weights as a name -> tensor dict, detached."""
        return {k: v.detach() for k, v in self.net.named_parameters()}

    def predict_with(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.net, params, (x,))

    def task_loss(self, params: dict, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
        return torch.mean((self.predict_with(params, x) - y) ** 2)

    def inner_adapted_loss(self, params: dict, x: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
        """INNER_STEPS of SGD at INNER_LR on the task, then the loss on the
        same points (reference train_MAML.py:157-176)."""
        fast = params
        for _ in range(INNER_STEPS):
            g = grad(self.task_loss)(fast, x, y)
            fast = {k: p - INNER_LR * g[k] for k, p in fast.items()}
        return self.task_loss(fast, x, y)

    def meta_loss(self, params: dict, xb: torch.Tensor,
                  yb: torch.Tensor) -> torch.Tensor:
        return torch.mean(vmap(lambda x, y: self.inner_adapted_loss(
            params, x, y))(xb, yb))

    def meta_step(self, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """One meta Adam step on tasks xb [B, K, 1], yb [B, K]; returns the
        meta loss."""
        xb, yb = xb.to(self.device), yb.to(self.device)
        grads, loss = grad_and_value(self.meta_loss)(self.weights(), xb, yb)
        self.optimizer.step([grads[k] for k, _ in
                             self.net.named_parameters()])
        return loss.detach()

    @torch.no_grad()
    def adapt_trajectory(self, support, x_query: torch.Tensor,
                         y_query: torch.Tensor, n_steps: int = 10,
                         lr: float = 0.01):
        """Plain SGD at lr on the support from the meta-weights, with the
        query MSE and the predictions after every step (reference
        train_MAML.py:206-300): (mses [n_steps+1], preds [n_steps+1, M])."""
        xs, ys = support
        p = self.weights()
        mses, preds = [], []
        for k in range(n_steps + 1):
            if k:
                with torch.enable_grad():
                    g = grad(self.task_loss)(p, xs, ys)
                p = {name: w - lr * g[name] for name, w in p.items()}
            pred = self.predict_with(p, x_query)
            mses.append(torch.mean((pred - y_query) ** 2))
            preds.append(pred)
        return torch.stack(mses), torch.stack(preds)

    @torch.no_grad()
    def adapt_predict(self, support, x_query: torch.Tensor,
                      n_steps: int = 10, lr: float = 0.01) -> torch.Tensor:
        """Predictions at x_query after n_steps of a fresh Adam(lr) on the
        support from the meta-weights (reference train_MAML.py:206-245)."""
        xs, ys = support
        p = {k: v.clone() for k, v in self.weights().items()}
        opt = Adam(list(p.values()), lr)
        for _ in range(n_steps):
            with torch.enable_grad():
                g = grad(self.task_loss)(p, xs, ys)
            opt.step([g[k] for k in p])
        return self.predict_with(p, x_query)


def main(argv=None, device=None):
    args = common.parse_args("train_MAML", default_iters=10000, argv=argv,
                             default_task_batch=25)
    rng = np.random.RandomState(args.seed)
    tasks = common.train_tasks()

    # an explicit --task_batch is honoured; the default is 25 because the
    # meta objective averages over a batch of tasks
    maml = SinesMAML(meta_batch=args.task_batch, device=device)
    maml.init(torch.Generator().manual_seed(args.seed))
    dev = maml.device

    for it in range(args.iterations):
        xb, yb = tasks.sample_batch(rng, maml.meta_batch,
                                    common.N_SHOT_TRAIN, noise=0.1)
        loss = maml.meta_step(torch.from_numpy(xb), torch.from_numpy(yb))
        if it % 100 == 0:
            print(f"[{it}] - MetaLoss: {float(loss):.3f}")

    print("Test, please wait...")
    tt = common.test_tasks(args.out_of_range)
    mses = []
    for _ in range(args.n_test_tasks):
        _, xs, ys, xq, yq, _, _ = common.sample_eval_task(rng, tt)
        xs, ys, xq, yq = (torch.from_numpy(a).to(dev)
                          for a in (xs, ys, xq, yq))
        pred = maml.adapt_predict((xs, ys), xq, n_steps=10)
        mses.append(float(torch.mean((pred - yq) ** 2)))
    common.report("MAML", mses)

    test_hi = 10.0 if args.out_of_range else 5.0
    for i in range(args.n_plots):
        task, xs, ys, _, _, x_all, _ = common.sample_eval_task(rng, tt)
        pred = maml.adapt_predict(
            (torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)),
            torch.from_numpy(x_all).to(dev), n_steps=10)
        common.save_uncertainty_plot(i, "MAML", task, xs, ys, x_all,
                                     pred.cpu().numpy(), test_hi=test_hi)

    if args.analysis:
        analysis(maml, rng, tt, args.analysis, test_hi)
    return mses


def analysis(maml: SinesMAML, rng, tt, n_tasks: int, test_hi: float,
             n_steps: int = 10, out_dir: str = "plots"):
    """Adaptation-speed analysis (reference sines/train_MAML.py:206-330):
    the query-MSE curve averaged over n_tasks random tasks
    (average_losses), and one task's adapted functions after sampled step
    counts (plot_sampled_performance), saved under out_dir. Returns the
    curve."""
    dev = maml.device
    curves, keep = [], None
    for _ in range(n_tasks):
        task, xs, ys, xq, yq, x_all, _ = common.sample_eval_task(rng, tt)
        mses, _ = maml.adapt_trajectory(
            (torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)),
            torch.from_numpy(xq).to(dev), torch.from_numpy(yq).to(dev),
            n_steps=n_steps)
        curves.append(mses.cpu().numpy())
        if keep is None:
            keep = (task, xs, ys, x_all)
    curve = np.mean(curves, axis=0)
    print("MAML adaptation curve (avg query MSE after k steps):")
    for k, v in enumerate(curve):
        print(f"  step {k:2d}: {v:.4f}")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots()
    ax.plot(range(len(curve)), curve, marker="o")
    ax.set_xlabel("adaptation steps")
    ax.set_ylabel("avg query MSE")
    ax.set_title(f"MAML adaptation over {n_tasks} tasks")
    fig.savefig(os.path.join(out_dir, "MAML_adaptation_curve.png"), dpi=120)
    plt.close(fig)

    task, xs, ys, x_all = keep
    _, preds = maml.adapt_trajectory(
        (torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)),
        torch.from_numpy(x_all).to(dev),
        torch.zeros(len(x_all), device=dev), n_steps=n_steps)
    preds = preds.cpu().numpy()
    fig, ax = plt.subplots()
    grid = np.linspace(-5.0, test_hi, 400)
    ax.plot(grid, [task.true_function(x) for x in grid], color="blue",
            label="true")
    for k in (0, 1, n_steps):
        ax.plot(x_all, preds[k], alpha=0.7, label=f"{k} steps")
    ax.scatter(xs, ys, color="black", marker="*", zorder=5, label="support")
    ax.legend()
    fig.savefig(os.path.join(out_dir, "MAML_sampled_steps.png"), dpi=120)
    plt.close(fig)
    return curve


if __name__ == "__main__":
    main()
