"""Minimal, dependency-free Gaussian-process Bayesian optimization core.

Own copy of ``rafiki_tpu/advisor/gp.py`` (numpy only). Operates on the
unit cube [0,1]^d (each knob encodes itself, ``sdk/knob.py``) and
maximizes expected improvement; pending (proposed, not yet scored) points
are fantasized at the observed minimum (constant liar), so concurrent
proposals spread out. The original's infeasible-point penalties (a trial
that failed without a score) wait with the rest of the trial-fault
taxonomy (ROADMAP.md); without them both propose the same points.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np


def _matern52(X1: np.ndarray, X2: np.ndarray, lengthscale: float) -> np.ndarray:
    d = np.sqrt(
        np.maximum(
            ((X1[:, None, :] - X2[None, :, :]) ** 2).sum(-1), 0.0
        )
    )
    r = math.sqrt(5.0) * d / lengthscale
    return (1.0 + r + r * r / 3.0) * np.exp(-r)


class GaussianProcess:
    """GP with Matérn-5/2 kernel, standardized targets, and a small
    marginal-likelihood grid search over the lengthscale."""

    NOISE = 1e-6

    def __init__(self) -> None:
        self.X: Optional[np.ndarray] = None
        self.y: Optional[np.ndarray] = None
        self._chol: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._ls = 0.3
        self._y_mean = 0.0
        self._y_std = 1.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> None:
        self.X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        self.y = (y - self._y_mean) / self._y_std
        best_ll, best_ls = -np.inf, self._ls
        for ls in (0.1, 0.2, 0.3, 0.5, 1.0):
            ll = self._marginal_ll(ls)
            if ll > best_ll:
                best_ll, best_ls = ll, ls
        self._ls = best_ls
        K = _matern52(self.X, self.X, self._ls) + self.NOISE * np.eye(len(self.X))
        self._chol = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, self.y)
        )

    def _marginal_ll(self, ls: float) -> float:
        assert self.X is not None and self.y is not None
        K = _matern52(self.X, self.X, ls) + self.NOISE * np.eye(len(self.X))
        try:
            L = np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            return -np.inf
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, self.y))
        return float(
            -0.5 * self.y @ alpha - np.log(np.diag(L)).sum()
        )

    def predict(self, Xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and stddev at query points (de-standardized)."""
        assert self.X is not None and self._chol is not None
        Ks = _matern52(np.asarray(Xs, dtype=np.float64), self.X, self._ls)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._chol, Ks.T)
        var = np.maximum(1.0 + self.NOISE - (v * v).sum(0), 1e-12)
        return (
            mu * self._y_std + self._y_mean,
            np.sqrt(var) * self._y_std,
        )


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    from math import erf

    return 0.5 * (1.0 + np.vectorize(erf)(z / math.sqrt(2)))


def expected_improvement(
    mu: np.ndarray, sigma: np.ndarray, best: float, xi: float = 0.01
) -> np.ndarray:
    imp = mu - best - xi
    z = imp / sigma
    return imp * _norm_cdf(z) + sigma * _norm_pdf(z)


class BayesOpt:
    """Sequential maximizer over [0,1]^d with pending-point fantasies."""

    N_CANDIDATES = 2048

    def __init__(self, dims: int, seed: int = 0):
        self.dims = dims
        self.rng = np.random.default_rng(seed)
        self.observed_X: List[np.ndarray] = []
        self.observed_y: List[float] = []
        self.pending_X: List[np.ndarray] = []

    @property
    def n_warmup(self) -> int:
        return max(3, self.dims)

    def suggest(self, register_pending: bool = True) -> np.ndarray:
        """Next point to evaluate. Random during warmup; EI afterwards, with
        pending points fantasized at the current minimum (constant liar).

        With ``register_pending=False`` the caller is expected to call
        ``mark_pending`` itself (e.g. after quantizing the point to the knob
        grid, so the later ``observe`` can retire it by value)."""
        if self.dims == 0:
            return np.zeros(0)
        if len(self.observed_X) < self.n_warmup:
            x = self.rng.random(self.dims)
        else:
            X = np.array(self.observed_X)
            y = np.array(self.observed_y)
            if self.pending_X:
                X = np.vstack([X, np.array(self.pending_X)])
                y = np.concatenate([y, np.full(len(self.pending_X),
                                               float(y.min()))])
            gp = GaussianProcess()
            gp.fit(X, y)
            cand = self.rng.random((self.N_CANDIDATES, self.dims))
            # include jittered copies of the incumbent for local refinement
            best_x = self.observed_X[int(np.argmax(self.observed_y))]
            local = np.clip(
                best_x + 0.05 * self.rng.standard_normal((64, self.dims)), 0, 1
            )
            cand = np.vstack([cand, local])
            mu, sigma = gp.predict(cand)
            ei = expected_improvement(mu, sigma, float(np.max(self.observed_y)))
            x = cand[int(np.argmax(ei))]
        if register_pending:
            self.mark_pending(x)
        return x

    def mark_pending(self, x: np.ndarray) -> None:
        self.pending_X.append(np.asarray(x, dtype=np.float64))

    def observe(self, x: np.ndarray, y: float) -> None:
        x = np.asarray(x, dtype=np.float64)
        self.observed_X.append(x)
        self.observed_y.append(float(y))
        # Retire one fantasy per real observation: the nearest pending point.
        # (Feedback may arrive for points proposed elsewhere or quantized to a
        # knob grid, so exact matching would leak fantasies forever.)
        if self.pending_X:
            d = [float(((p - x) ** 2).sum()) for p in self.pending_X]
            self.pending_X.pop(int(np.argmin(d)))
