"""DKT: one-vs-rest deep-kernel GP few-shot classification.

Port of deep_kernel_transfer_tpu/methods/dkt.py (reference methods/DKT.py):

    images [B, n_way, S+Q, H, W, C]
      -> trunk once over the flat batch, per-episode BatchNorm    [B, N, D]
      -> bn_out + L2 normalisation (bncossim)
      -> per episode and way: Gram, Cholesky, MLL                  [B, W]
      -> -sum over ways, mean over episodes -> Adam with two rates

The GP tail takes one of two routes. With use_fused_mll (the default here,
and the main path on the card) one CUDA kernel computes every episode's
Gram, Choleskys and MLLs (ops/fused_mll.py); otherwise the batched dense
ExactGP engine does (gp/exact.py). The JAX package defaults to its plain
route, because there its Pallas kernel was slower than XLA.

Semantics kept from the reference: GP trained on support and query during
meta-training, conditioned on the support set only at test time; +-1
one-vs-rest targets; prediction = argmax over ways of sigmoid(posterior
mean); fixed noise 0.1; GP hyperparameters at lr 1e-4 and the trunk at
1e-3, with Adam's state reset every epoch (reset_opt_state).

The test-time heads of reference methods/DKT.py:207-256 (JAX
dkt.py:362-459): the Laplace GP classifier on the support features
(gp/laplace.py, --laplace), and per-episode adaptation of the GP
hyperparameters by Adam on the support MLL before scoring (--adaptation),
whose MLL runs through the fused kernel with per-episode parameters where
it applies (the JAX package adapts through its plain route).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .._device import resolve_device
from ..gp import ExactGP, GaussianLikelihood, make_kernel, normalizes_features
from ..gp.exact import init_batched
from ..gp.kernels import softplus
from ..gp.laplace import laplace_ovr_predict
from ..models.backbones import EpisodicBatchNorm
from ..ops.fused_mll import fused_linear_mll, supports
from ..utils.adam import Adam
from ..utils.profiling import annotate
from .base import (apply_trunk, episode_labels, flatten_episode,
                   one_vs_rest_targets, query_accuracy, train_step_body)


def add_bn_out(backbone: nn.Module, dim: int) -> nn.Module:
    """The bncossim head (JAX DKTFeature, reference methods/DKT.py:45-48):
    a BatchNorm1d over the trunk's flat features, appended to the trunk as
    `trunk.bn_out`, the name the reference's state_dict uses."""
    backbone.trunk.add_module("bn_out", EpisodicBatchNorm(dim))
    return backbone


class ParamTree(nn.Module):
    """A nested dict of tensors held as nn.Parameters; state_dict keys
    follow the dict path (gp.kernel.raw_outputscale, ...)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(key, nn.Parameter(value))

    def tree(self) -> dict:
        out = dict(self.named_parameters(recurse=False))
        out.update({k: m.tree() for k, m in self.named_children()})
        return out


def _slice_ways(tree: dict, n_way: int) -> dict:
    return {k: _slice_ways(v, n_way) if isinstance(v, dict) else v[:n_way]
            for k, v in tree.items()}


def _leaves(tree: dict) -> list:
    """Every leaf of a nested dict, in insertion order."""
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _fill(template: dict, leaves) -> dict:
    """template's structure with its leaves taken in order from `leaves`."""
    it = iter(leaves)

    def fill(t):
        return {k: fill(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}

    return fill(template)


class DKT(nn.Module):
    """DKT method. Build, then `init(example_episode)` before training.

    Modules: `feature` (the trunk, with `trunk.bn_out` for bncossim) and
    `gp` (per-way GP parameters with a leading [n_way] axis:
    mean.constant, kernel.raw_outputscale and, for `linear`,
    kernel.base.raw_variance). `spec` is the ExactGP configuration.
    """

    def __init__(self, backbone: nn.Module, n_way: int, n_support: int,
                 kernel_type: str = "bncossim", gp_lr: float = 1e-4,
                 feature_lr: float = 1e-3, noise: float = 0.1,
                 feature_dtype: str = "bfloat16", use_fused_mll: bool = True,
                 force_dense: bool | None = None, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.n_way = n_way
        self.n_support = n_support
        self.kernel_type = kernel_type
        self.feature_dtype = getattr(torch, feature_dtype)
        self.use_fused_mll = use_fused_mll
        self.normalize = normalizes_features(kernel_type)
        self.gp_lr = gp_lr
        self.feature_lr = feature_lr
        # PSD kernel + fixed noise >= 1e-2: the noisy Gram is PD by
        # construction, so the jitter search is skipped (JAX dkt.py:117-122).
        # force_dense None reads DKT_GP_FORCE_DENSE once, here (JAX
        # dkt.py:103-110): it keeps the low-rank kernels off the Woodbury
        # route
        if force_dense is None:
            force_dense = ExactGP.force_dense_from_env()
        self.spec = ExactGP(
            make_kernel(kernel_type),
            GaussianLikelihood(trainable=False, fixed_noise=noise),
            assume_pd=noise >= 1e-2, force_dense=force_dense)
        self.feature = backbone
        self.gp = None
        self.optimizer = None

    # -- init --------------------------------------------------------------

    def init(self, example_episode: torch.Tensor, generator=None) -> "DKT":
        """Initialise every parameter for episodes shaped like
        example_episode [n_way, S+Q, H, W, C] (content ignored): fan-in
        conv weights drawn from `generator`, unit BatchNorms, the bncossim
        head sized for the image, the GP's softplus(0) constants, and a
        fresh optimizer. Returns self."""
        h, w = example_episode.shape[-3], example_episode.shape[-2]
        self.feature.reset_parameters(generator)
        if self.kernel_type.lower() == "bncossim":
            add_bn_out(self.feature, self.feature.out_dim(h, w))
        self.gp = ParamTree(init_batched(self.spec, self.n_way,
                                         device=self.device))
        self.to(self.device)
        self.reset_opt_state()
        return self

    def reset_opt_state(self) -> None:
        """A fresh Adam (the reference recreates it every epoch,
        methods/DKT.py:114-115): GP parameters at gp_lr, the trunk at
        feature_lr, optax's defaults otherwise."""
        self.optimizer = torch.optim.Adam(
            [{"params": list(self.gp.parameters()), "lr": self.gp_lr},
             {"params": list(self.feature.parameters()),
              "lr": self.feature_lr}],
            betas=(0.9, 0.999), eps=1e-8)

    # -- core --------------------------------------------------------------

    def _features(self, x_flat: torch.Tensor, train: bool = False,
                  ep_groups: int = 1):
        """(features [N, D], stats): the trunk under the mixed-precision
        law of base.apply_trunk, then L2 normalisation for cossim and
        bncossim."""
        z, stats = apply_trunk(self.feature, x_flat, train,
                               dtype=self.feature_dtype, ep_groups=ep_groups)
        if self.normalize:
            z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-12)
        return z, stats

    def _gp_params_for(self, n_way: int) -> dict:
        """GP params for an n_way-way episode: a model trained with more
        ways evaluates with its first n_way per-way GPs (change_way,
        reference meta_template.py:18)."""
        gp = self.gp.tree()
        if n_way == self.n_way:
            return gp
        if n_way > self.n_way:
            raise ValueError(f"episode has {n_way} ways but the model holds "
                             f"{self.n_way} per-way GP parameter sets")
        return _slice_ways(gp, n_way)

    def batch_loss_train(self, xb: torch.Tensor):
        """(mean over episodes of -sum_way MLL, BatchNorm stats) for
        xb [B, n_way, S+Q, H, W, C]; the GP is fit to support and query
        (reference methods/DKT.py:126-164)."""
        xb = xb.to(self.device)
        b, n_way, n_total = xb.shape[0], xb.shape[1], xb.shape[2]
        n = n_way * n_total
        z, stats = self._features(xb.reshape((b * n,) + tuple(xb.shape[3:])),
                                  train=True, ep_groups=b)
        z = z.reshape(b, n, z.shape[-1])
        targets = one_vs_rest_targets(n_way, n_total, self.device)
        mll = self._mll(self._gp_params_for(n_way), z, targets)
        return -torch.mean(torch.sum(mll, dim=1)), stats

    def _mll(self, gp: dict, z: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        """Per-way MLLs [B, W] of targets [W, N] at features z [B, N, D].
        The GP params' leaves are [W] (shared by the episodes) or [B, W]
        (each episode's own). The fused kernel where it applies, else the
        batched ExactGP engine."""
        n = z.shape[1]
        with annotate("gp"):
            if self.use_fused_mll and supports(self.kernel_type, n):
                diffs = targets - gp["mean"]["constant"][..., None]
                scales = softplus(gp["kernel"]["raw_outputscale"])
                base = gp["kernel"]["base"]
                if "raw_variance" in base:  # 'linear' kernel_type
                    scales = scales * softplus(base["raw_variance"])
                return fused_linear_mll(
                    z, diffs, scales, n,
                    float(self.spec.likelihood.fixed_noise))
            return self.spec.mll(gp, z[:, None], targets)

    def train_step(self, xb: torch.Tensor, average=None) -> dict:
        """One optimizer step on the episode batch; returns the loss and
        the hyperparameter telemetry (reference methods/DKT.py:148-157).
        `average`: see base.train_step_body."""
        metrics = train_step_body(self, xb, average)
        return {**metrics, **self._hyper_metrics()}

    @torch.no_grad()
    def _hyper_metrics(self) -> dict:
        """Mean outputscale, lengthscale (rbf, matern) and noise (JAX
        dkt.py:247-260)."""
        kernel = self.gp.tree()["kernel"]
        out = {"outputscale": torch.mean(softplus(kernel["raw_outputscale"]))}
        if "raw_lengthscale" in kernel["base"]:
            out["lengthscale"] = torch.mean(
                softplus(kernel["base"]["raw_lengthscale"]))
        out["noise"] = torch.tensor(self.spec.likelihood.fixed_noise)
        return out

    @torch.no_grad()
    def train_telemetry(self, xb: torch.Tensor) -> dict:
        """The training telemetry of every print_freq batches (reference
        methods/DKT.py:167-196; JAX dkt.py:262-293): support and query
        accuracy in percent, averaged over the B episodes of xb, with each
        episode's GP conditioned on its support and query points under
        eval-mode BatchNorm (one batched posterior), and the first
        episode's support features as `z_support` [n_way*S, D]."""
        xb = xb.to(self.device)
        b, n_way, n_total = xb.shape[0], xb.shape[1], xb.shape[2]
        n = n_way * n_total
        z, _ = self._features(xb.reshape((b * n,) + tuple(xb.shape[3:])))
        z = z.reshape(b, n, z.shape[-1])
        targets = one_vs_rest_targets(n_way, n_total, self.device)
        post = self.spec.posterior(self._gp_params_for(n_way), z[:, None],
                                   targets, z[:, None])
        pred = torch.argmax(torch.sigmoid(post.mean), dim=1)  # [B, N]
        hit = (pred == episode_labels(n_way, n_total, self.device)).reshape(
            b, n_way, n_total).to(torch.float32)
        s = self.n_support
        z_support = z[0].reshape(n_way, n_total, -1)[:, :s].reshape(
            n_way * s, -1)
        return {"GP_support_accuracy": hit[..., :s].mean() * 100.0,
                "GP_query_accuracy": hit[..., s:].mean() * 100.0,
                "z_support": z_support}

    # -- prediction --------------------------------------------------------

    def _logits_from_features(self, z_all: torch.Tensor, n_way: int,
                              n_total: int, condition_on_all: bool = False,
                              gp: dict | None = None) -> torch.Tensor:
        """Posterior means at the queries, [..., n_way*Q, n_way], from
        features z_all [..., n_way*n_total, D] (eval protocol: GP
        conditioned on the support set, or on everything). `gp` replaces
        the model's GP params, e.g. by adapted ones with leaves [B, W]."""
        with annotate("posterior"):
            s = self.n_support
            lead, d = z_all.shape[:-2], z_all.shape[-1]
            z = z_all.reshape(lead + (n_way, n_total, d))
            z_query = z[..., s:, :].reshape(lead + (-1, d))
            if gp is None:
                gp = self._gp_params_for(n_way)
            if condition_on_all:
                x_train = z_all
                targets = one_vs_rest_targets(n_way, n_total, z_all.device)
            else:
                x_train = z[..., :s, :].reshape(lead + (n_way * s, d))
                targets = one_vs_rest_targets(n_way, s, z_all.device)
            # the way axis of the GP params sits before the points axis
            post = self.spec.posterior(gp, x_train.unsqueeze(-3), targets,
                                       z_query.unsqueeze(-3))
            return post.mean.transpose(-1, -2)

    def _batch_features(self, xb: torch.Tensor) -> torch.Tensor:
        """Eval-mode features [B, n_way*(S+Q), D] of xb [B, n_way, S+Q,
        H, W, C]: one trunk forward over the flat batch."""
        b, n_way, n_total = xb.shape[0], xb.shape[1], xb.shape[2]
        z, _ = self._features(
            xb.reshape((b * n_way * n_total,) + tuple(xb.shape[3:])))
        return z.reshape(b, n_way * n_total, z.shape[-1])

    def batch_logits(self, xb: torch.Tensor) -> torch.Tensor:
        """[B, n_way*Q, n_way] posterior means, eval-mode BatchNorm."""
        xb = xb.to(self.device)
        return self._logits_from_features(self._batch_features(xb),
                                          xb.shape[1], xb.shape[2])

    def episode_logits(self, x: torch.Tensor,
                       condition_on_all: bool = False) -> torch.Tensor:
        """[n_way*Q, n_way] posterior means for one episode
        [n_way, S+Q, H, W, C] (reference methods/DKT.py:297-335)."""
        z_all, _ = self._features(flatten_episode(x.to(self.device)))
        return self._logits_from_features(z_all, x.shape[0], x.shape[1],
                                          condition_on_all)

    def episode_scores(self, x: torch.Tensor) -> torch.Tensor:
        """sigmoid(mean) scores (reference methods/DKT.py:258-271)."""
        return torch.sigmoid(self.episode_logits(x))

    @torch.no_grad()
    def batch_scores(self, xb: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.batch_logits(xb))

    @torch.no_grad()
    def correct(self, x: torch.Tensor) -> tuple[float, int]:
        """(top-1 correct, count) on one episode (reference
        methods/DKT.py:199-272)."""
        n_way, n_query = x.shape[0], x.shape[1] - self.n_support
        y = episode_labels(n_way, n_query, self.device)
        pred = torch.argmax(self.episode_scores(x), dim=-1)
        return float((pred == y).sum()), n_way * n_query

    @torch.no_grad()
    def batch_correct(self, xb: torch.Tensor) -> torch.Tensor:
        """Per-episode query accuracy in percent, [B]."""
        return query_accuracy(
            torch.argmax(self.batch_scores(xb), dim=-1), xb.shape[1])

    # -- the Laplace head (reference methods/DKT.py:207-222) ---------------

    def _laplace_pred(self, z_all: torch.Tensor, n_way: int,
                      n_total: int) -> torch.Tensor:
        """Query class ids [..., n_way*Q] from the Laplace GPC (1.0 *
        RBF(0.1), one-vs-rest) fit to the support features of z_all
        [..., n_way*n_total, D]; every way of every episode in one batched
        Newton solve (JAX dkt.py:362-374)."""
        s = self.n_support
        lead, d = z_all.shape[:-2], z_all.shape[-1]
        z = z_all.reshape(lead + (n_way, n_total, d))
        z_support = z[..., :s, :].reshape(lead + (n_way * s, d))
        z_query = z[..., s:, :].reshape(lead + (-1, d))
        return laplace_ovr_predict(z_support,
                                   episode_labels(n_way, s, z_all.device),
                                   z_query, n_way)

    @torch.no_grad()
    def _episode_laplace_pred(self, x: torch.Tensor) -> torch.Tensor:
        """[n_way*Q] predicted class ids of one episode [n_way, S+Q, H, W,
        C] from the Laplace head."""
        z_all, _ = self._features(flatten_episode(x.to(self.device)))
        return self._laplace_pred(z_all, x.shape[0], x.shape[1])

    @torch.no_grad()
    def correct_laplace(self, x: torch.Tensor) -> tuple[float, int]:
        """(top-1 correct, count) of one episode under the Laplace head
        (JAX dkt.py:376-386)."""
        n_way, n_query = x.shape[0], x.shape[1] - self.n_support
        y = episode_labels(n_way, n_query, self.device)
        pred = self._episode_laplace_pred(x)
        return float((pred == y).sum()), n_way * n_query

    @torch.no_grad()
    def batch_correct_laplace(self, xb: torch.Tensor) -> torch.Tensor:
        """Per-episode Laplace-head accuracy in percent, [B] (JAX
        dkt.py:388-400)."""
        xb = xb.to(self.device)
        n_way, n_total = xb.shape[1], xb.shape[2]
        return query_accuracy(
            self._laplace_pred(self._batch_features(xb), n_way, n_total),
            n_way)

    # -- test-time GP adaptation (reference methods/DKT.py:249-256) --------

    def adapt_gp(self, xb: torch.Tensor, steps: int, lr: float = 1e-3,
                 z_all: torch.Tensor | None = None) -> dict:
        """Each episode's GP hyperparameters after `steps` Adam steps (optax
        adam(lr)) against its support-set sum-MLL (JAX dkt.py:425-459).

        xb [B, n_way, S+Q, H, W, C]; z_all [B, n_way*(S+Q), D], the
        episodes' eval-mode features, reuses a trunk forward. Returns a GP
        params tree with leaves [B, n_way]; the model's own parameters and
        optimizer are left untouched. The B episodes step together: the
        loss is the sum of their losses, so each leaf's gradient row is its
        own episode's gradient, and one fused-MLL forward and backward serve
        the whole batch at each step."""
        n_way, s = xb.shape[1], self.n_support
        b = xb.shape[0]
        if z_all is None:
            with torch.no_grad():
                z_all = self._batch_features(xb.to(self.device))
        d = z_all.shape[-1]
        z_support = z_all.detach().reshape(b, n_way, -1, d)[:, :, :s].reshape(
            b, n_way * s, d)
        targets = one_vs_rest_targets(n_way, s, self.device)
        gp0 = self._gp_params_for(n_way)
        leaves = [v.detach().expand((b,) + v.shape).clone().requires_grad_(True)
                  for v in _leaves(gp0)]
        opt = Adam(leaves, lr)
        for _ in range(steps):
            with torch.enable_grad():
                loss = -torch.sum(self._mll(_fill(gp0, leaves), z_support,
                                            targets))
                grads = torch.autograd.grad(loss, leaves)
            opt.step(grads)
        return _fill(gp0, [p.detach() for p in leaves])

    def batch_correct_adapted(self, xb: torch.Tensor, steps: int,
                              lr: float = 1e-3) -> torch.Tensor:
        """Per-episode accuracy in percent [B] after `steps` of per-episode
        GP adaptation on the support set (--adaptation; JAX
        dkt.py:402-423): one trunk forward serves the adaptation and the
        scoring."""
        xb = xb.to(self.device)
        n_way, n_total = xb.shape[1], xb.shape[2]
        with torch.no_grad():
            z_all = self._batch_features(xb)
        gp = self.adapt_gp(xb, steps, lr, z_all=z_all)
        with torch.no_grad():
            logits = self._logits_from_features(z_all, n_way, n_total, gp=gp)
        return query_accuracy(
            torch.argmax(torch.sigmoid(logits), dim=-1), n_way)
