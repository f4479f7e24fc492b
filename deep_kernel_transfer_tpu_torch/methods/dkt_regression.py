"""DKT regression: one exact GP over deep features (QMUL, sines).

Port of deep_kernel_transfer_tpu/methods/dkt_regression.py (reference
methods/DKT_regression.py, sines/train_DKT.py): a feature net (Conv3 for
QMUL, MLP2 for sines) feeds an exact GP with a trainable Gaussian noise
and an rbf or ARD spectral-mixture kernel; training minimises the -MLL of
each task, testing conditions on the support points and predicts with the
observation noise.

    tasks [B, N, ...] -> trunk over the flat batch, true f32   [B, N, D]
      -> per task: Gram, jittered Cholesky, MLL               [B]
      -> train_step: mean over tasks -> one Adam step
         unbatched_train_step: one Adam step per task, in order

The noise is trainable, so every factorisation goes through
psd_safe_cholesky's jitter search. Adam at lr over every parameter, one
group (reference train_regression.py:33-34).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .._device import resolve_device
from ..gp import ExactGP, GaussianLikelihood, make_kernel
from ..gp.kernels import initialize_spectral_from_data
from ..models.backbones import trunk_features
from .dkt import ParamTree


class DKTRegression(nn.Module):
    """Build, then `init(example_x)` before training.

    Modules: `feature` (the trunk) and `gp` (mean.constant, the kernel's
    raw parameters, likelihood.raw_noise). `spec` is the ExactGP
    configuration; `step` counts optimizer updates."""

    def __init__(self, backbone: nn.Module, feat_dim: int,
                 kernel_type: str = "rbf", lr: float = 1e-3,
                 num_mixtures: int = 4, force_dense: bool | None = None,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.kernel_type = kernel_type
        self.lr = lr
        # force_dense None reads DKT_GP_FORCE_DENSE once, here, as DKT does
        if force_dense is None:
            force_dense = ExactGP.force_dense_from_env()
        self.spec = ExactGP(
            make_kernel(kernel_type, dim=feat_dim, num_mixtures=num_mixtures),
            GaussianLikelihood(trainable=True), force_dense=force_dense)
        self.feature = backbone
        self.gp = None
        self.optimizer = None
        self.step = 0

    def init(self, example_x: torch.Tensor = None,
             generator=None) -> "DKTRegression":
        """Initialise every parameter from `generator` (trunk weights, the
        spectral mixture's means and scales) and a fresh optimizer. The
        trunks' shapes do not depend on the input, so example_x (one task
        [N, ...], as in the JAX package) is not read. Returns self."""
        self.feature.reset_parameters(generator)
        self.gp = ParamTree(self.spec.init(device=self.device,
                                           generator=generator))
        self.to(self.device)
        self.reset_optimizer()
        self.step = 0
        return self

    def reset_optimizer(self) -> None:
        """A fresh Adam at lr over every parameter."""
        self.optimizer = torch.optim.Adam(self.parameters(), lr=self.lr,
                                          betas=(0.9, 0.999), eps=1e-8)

    # -- core --------------------------------------------------------------

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """Features [..., N, D] of inputs [..., N, ...], the trunk run once
        over the flat batch in true f32."""
        return trunk_features(self.feature, x.to(self.device))

    def task_loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """-MLL of one task, the GP conditioned on all its points
        (reference methods/DKT_regression.py:48-57). x [N, ...], y [N]."""
        z = self._features(x)
        return -self.spec.mll(self.gp.tree(), z, y.to(self.device))

    def batch_loss(self, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """Mean -MLL over a batch of tasks xb [B, N, ...], yb [B, N]."""
        z = self._features(xb)
        return -torch.mean(self.spec.mll(self.gp.tree(), z,
                                         yb.to(self.device)))

    def _update(self, loss: torch.Tensor) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()

    def _noise(self) -> torch.Tensor:
        return self.spec.likelihood.noise(self.gp.tree()["likelihood"]).detach()

    def train_step(self, xb: torch.Tensor, yb: torch.Tensor) -> dict:
        """One Adam step on the mean -MLL over the B tasks."""
        loss = self.batch_loss(xb, yb)
        self._update(loss)
        self.step += 1
        return {"loss": loss.detach(), "noise": self._noise()}

    def unbatched_train_step(self, xb: torch.Tensor, yb: torch.Tensor) -> dict:
        """One Adam step per task, in order (the reference's per-person
        loop, methods/DKT_regression.py:45-64; JAX dkt_regression.py
        :101-122); step counts every update. The loss is the tasks' mean."""
        xb, yb = xb.to(self.device), yb.to(self.device)
        losses = []
        for x, y in zip(xb, yb):
            loss = self.task_loss(x, y)
            self._update(loss)
            losses.append(loss.detach())
        self.step += xb.shape[0]
        return {"loss": torch.mean(torch.stack(losses)),
                "noise": self._noise()}

    def init_spectral_from_data(self, x: torch.Tensor, y: torch.Tensor,
                                generator=None) -> "DKTRegression":
        """Optional data-driven spectral-mixture init over the current
        features of one task (JAX dkt_regression.py:124-139): the kernel's
        raw parameters are replaced and the optimizer's state restarts;
        the step count runs on."""
        if self.kernel_type != "spectral":
            return self
        with torch.no_grad():
            z = self._features(x)
            new = initialize_spectral_from_data(
                self.gp.tree()["kernel"], z, y.to(self.device), generator)
            for name, value in new.items():
                getattr(self.gp.kernel, name).copy_(value)
        self.reset_optimizer()
        return self

    # -- evaluation --------------------------------------------------------

    @torch.no_grad()
    def predict(self, x_support: torch.Tensor, y_support: torch.Tensor,
                x_query: torch.Tensor, full_covariance: bool = False):
        """Posterior with the observation noise at the query points, the
        `likelihood(model(z_query))` of reference
        methods/DKT_regression.py:90-93: a MultivariateNormal over [M]."""
        gp = self.gp.tree()
        z_s = self._features(x_support)
        z_q = self._features(x_query)
        post = self.spec.posterior(gp, z_s, y_support.to(self.device), z_q,
                                   full_covariance=full_covariance)
        return self.spec.likelihood(gp["likelihood"], post)

    def test_mse(self, x_support, y_support, x_query, y_query) -> float:
        pred = self.predict(x_support, y_support, x_query)
        return float(torch.mean((pred.mean - y_query.to(self.device)) ** 2))
