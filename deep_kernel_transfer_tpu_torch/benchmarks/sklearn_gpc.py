"""A float64 numpy/scipy copy of scikit-learn's Laplace Gaussian process
classifier, as the reference's --laplace head calls it.

The reference head (reference methods/DKT.py:207-222) fits
`GaussianProcessClassifier(kernel=1.0 * RBF(length_scale=0.1),
optimizer=None)`, one-vs-rest, to the support features of each episode.
With the optimizer off that is a short fixed algorithm, which this module
repeats in float64 on the host, so that the port's Laplace probe
(`laplace_probe.py`) needs no scikit-learn. It follows scikit-learn 1.9.0:

  * the kernel, `sklearn/gaussian_process/kernels.py` (RBF.__call__: pdist
    or cdist of X / length_scale, exp(-d^2 / 2), a unit diagonal; the
    constant 1.0 multiplies it, and its diag is 1);
  * the binary fit, `_gpc.py:171-267`: K of the training points, then
    `_posterior_mode` (`_gpc.py:443-491`): Newton from f = 0 for at most
    max_iter_predict = 100 iterations, with B = I + W^1/2 K W^1/2 factored
    by Cholesky, stopping when the log marginal likelihood gains less than
    1e-10; pi, W^1/2 and L kept from the last iteration's start;
  * the binary predict_proba, `_gpc.py:292-327` with `latent_mean_and_
    variance` (`:410-441`): the erf mixture of LAMBDAS and COEFS
    (`_gpc.py:30-33`) at the latent mean and variance;
  * one-vs-rest over three or more classes (`GaussianProcessClassifier.
    fit`, `_gpc.py:715-787`; scikit-learn fits one binary model for two
    classes, which the probe never has, so this copy refuses fewer than
    three): a binary model for each class against the rest
    (`sklearn/multiclass.py` OneVsRestClassifier.fit), `predict` the
    argmax, first index on a tie, over the classes of each model's
    positive-class probability (`multiclass.py:106-115, 482-505`), and
    `predict_proba` those probabilities normalised over the classes.

This is host code, as scikit-learn is: no TPU kernel and no Pallas kernel
stands behind it.
"""
from __future__ import annotations

import numpy as np
from scipy.linalg import cho_solve, cholesky, solve
from scipy.spatial.distance import cdist, pdist, squareform
from scipy.special import erf, expit

LENGTH_SCALE = 0.1  # the reference head's RBF(0.1) under a constant 1.0
MAX_ITER_PREDICT = 100  # scikit-learn's default Newton budget
# _gpc.py:30-33: the logistic sigmoid as a mixture of five error functions
LAMBDAS = np.array([0.41, 0.4, 0.37, 0.44, 0.39])[:, np.newaxis]
COEFS = np.array([-1854.8214151, 3516.89893646, 221.29346712, 128.12323805,
                  -2010.49422654])[:, np.newaxis]


def rbf_kernel(x: np.ndarray, y: np.ndarray | None = None) -> np.ndarray:
    """1.0 * RBF(LENGTH_SCALE) of x against y (x itself when y is None),
    as scikit-learn computes it."""
    if y is None:
        k = squareform(np.exp(-0.5 * pdist(x / LENGTH_SCALE, "sqeuclidean")))
        np.fill_diagonal(k, 1)
    else:
        k = np.exp(-0.5 * cdist(x / LENGTH_SCALE, y / LENGTH_SCALE,
                                "sqeuclidean"))
    return np.full(k.shape, 1.0) * k


class BinaryLaplaceGPC:
    """_BinaryGaussianProcessClassifierLaplace with the optimizer off."""

    def fit(self, x: np.ndarray, t: np.ndarray) -> "BinaryLaplaceGPC":
        """x [N, D] float64, t [N] in {0, 1}."""
        self.x_train = x
        self.y_train = np.asarray(t, np.float64)
        self.pi, self.w_sr, self.chol = self._posterior_mode(rbf_kernel(x))
        return self

    def _posterior_mode(self, k: np.ndarray):
        """(pi, W^1/2, L) of the last Newton iteration (_gpc.py:443-499)."""
        y = self.y_train
        f = np.zeros_like(y, dtype=np.float64)
        lml_prev = -np.inf
        for _ in range(MAX_ITER_PREDICT):
            pi = expit(f)
            w = pi * (1 - pi)
            w_sr = np.sqrt(w)
            w_sr_k = w_sr[:, np.newaxis] * k
            b_mat = np.eye(w.shape[0]) + w_sr_k * w_sr
            chol = cholesky(b_mat, lower=True)
            b = w * f + (y - pi)
            a = b - w_sr * cho_solve((chol, True), w_sr_k.dot(b))
            f = k.dot(a)
            lml = (-0.5 * a.T.dot(f)
                   - np.log1p(np.exp(-(y * 2 - 1) * f)).sum()
                   - np.log(np.diag(chol)).sum())
            if lml - lml_prev < 1e-10:
                break
            lml_prev = lml
        return pi, w_sr, chol

    def latent_mean_and_variance(self, x: np.ndarray):
        """Algorithm 3.2, lines 4-6 (_gpc.py:410-441)."""
        k_star = rbf_kernel(self.x_train, x)
        mean = k_star.T.dot(self.y_train - self.pi)
        v = solve(self.chol, self.w_sr[:, np.newaxis] * k_star)
        var = np.ones(x.shape[0]) - np.einsum("ij,ij->j", v, v)
        return mean, var

    def positive_proba(self, x: np.ndarray) -> np.ndarray:
        """predict_proba(x)[:, 1] (_gpc.py:292-327)."""
        mean, var = self.latent_mean_and_variance(x)
        alpha = 1 / (2 * var)
        gamma = LAMBDAS * mean
        integrals = (np.sqrt(np.pi / alpha)
                     * erf(gamma * np.sqrt(alpha / (alpha + LAMBDAS ** 2)))
                     / (2 * np.sqrt(var * 2 * np.pi)))
        return (COEFS * integrals).sum(axis=0) + 0.5 * COEFS.sum()


class GaussianProcessClassifier:
    """GaussianProcessClassifier(kernel=1.0 * RBF(LENGTH_SCALE),
    optimizer=None), one-vs-rest over three or more classes, in
    float64."""

    def fit(self, x, y) -> "GaussianProcessClassifier":
        x = np.asarray(x, np.float64)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if self.classes_.size < 3:
            raise ValueError("one-vs-rest needs 3 or more distinct classes; "
                             f"got {self.classes_.size}")
        self.estimators_ = [BinaryLaplaceGPC().fit(x, (y == c).astype(int))
                            for c in self.classes_]
        return self

    def binary_proba(self, x) -> np.ndarray:
        """[n_models, M]: each binary model's positive-class probability."""
        x = np.asarray(x, np.float64)
        return np.stack([e.positive_proba(x) for e in self.estimators_])

    def predict_proba(self, x) -> np.ndarray:
        """[M, n_classes] (OneVsRestClassifier.predict_proba: the binary
        probabilities normalised over the classes)."""
        p = self.binary_proba(x).T
        return p / np.sum(p, axis=1)[:, np.newaxis]

    def predict(self, x) -> np.ndarray:
        return self.classes_[np.argmax(self.binary_proba(x), axis=0)]
