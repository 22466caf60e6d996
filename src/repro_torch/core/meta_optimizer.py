"""Bandit-based Bayesian meta-optimizer (§4.4.2).

Continuous policy search over the meta-parameters

    Θ = {a_urg, b_urg, a_fair, b_fair, a_base, b_base, α_split}

maximizing the multi-objective reward R(Θ) (Eq. 5, core/monitor.py).  The
paper motivates Bayesian optimization because the scheduling landscape is
non-convex and discontinuous; convergence is observed within 5–8 trials
(App. B) — our benchmark reproduces that (benchmarks/bench_meta_optimizer).

Implementation: Gaussian-process surrogate (RBF kernel, unit signal prior,
estimated noise) + Expected Improvement acquisition maximized over a
quasi-random candidate sweep.  Pure numpy/scipy — the optimizer runs on the
host in the *strategic* (background) loop, never on the accelerator path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.linalg import cho_factor, cho_solve
from scipy.special import erf

from .types import MetaParams

# Search box for Θ (scaled units; see MetaParams docstring).
DEFAULT_BOUNDS = np.array([
    (-2.0, 2.0),    # a_urg
    (0.05, 4.0),    # b_urg   (>0 keeps Thm A.1 starvation freedom)
    (-2.0, 2.0),    # a_fair
    (0.0, 3.0),     # b_fair
    (-1.0, 1.0),    # a_base
    (0.0, 3.0),     # b_base
    (1.2, 8.0),     # alpha_split  (α > 1 per Eq. 2)
])


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)


def _norm_cdf(z):
    return 0.5 * (1.0 + erf(z / np.sqrt(2.0)))


class GaussianProcess:
    """Minimal GP regressor with RBF kernel for low-dim BO."""

    def __init__(self, length_scale: float = 0.35, signal: float = 1.0,
                 noise: float = 1e-3):
        self.ls = length_scale
        self.signal = signal
        self.noise = noise
        self.X: np.ndarray | None = None
        self.y_mean = 0.0
        self.y_std = 1.0
        self._alpha = None
        self._cho = None

    def _k(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return self.signal * np.exp(-0.5 * d2 / (self.ls ** 2))

    def fit(self, X: np.ndarray, y: np.ndarray) -> None:
        """Fit the Gaussian process to observed points and values."""
        self.X = np.atleast_2d(X)
        y = np.asarray(y, dtype=np.float64)
        self.y_mean = float(y.mean())
        self.y_std = float(y.std()) or 1.0
        yn = (y - self.y_mean) / self.y_std
        K = self._k(self.X, self.X) + self.noise * np.eye(len(yn))
        self._cho = cho_factor(K, lower=True)
        self._alpha = cho_solve(self._cho, yn)

    def predict(self, Xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and standard deviation at the given points."""
        Ks = self._k(np.atleast_2d(Xs), self.X)
        mu = Ks @ self._alpha
        v = cho_solve(self._cho, Ks.T)
        var = np.maximum(self.signal - np.einsum("ij,ji->i", Ks, v), 1e-12)
        return mu * self.y_std + self.y_mean, np.sqrt(var) * self.y_std


@dataclass
class Trial:
    """One evaluated meta-parameter vector and its reward."""
    theta: np.ndarray
    reward: float


def _trial_key(theta) -> tuple:
    """Dedup identity for a trial point: Θ rounded to 6 decimals (scaled
    units) — the one definition shared by local optimizers and the fleet
    policy store, so both sides agree on which trials are 'the same'."""
    return tuple(np.round(np.asarray(theta, dtype=np.float64), 6))


def pool_trials(existing, new, cap: int) -> list[tuple[list[float], float]]:
    """Merge (Θ, reward) observation lists: first-seen wins on duplicate Θ,
    and over ``cap`` total the lowest-reward entries are dropped (relative
    order otherwise preserved).  Serializable-tuple domain — used by the
    fleet policy store and ``BayesianMetaOptimizer.merge_trials``."""
    out = [(list(t), float(r)) for t, r in existing]
    seen = {_trial_key(t) for t, _ in out}
    for theta, r in new:
        key = _trial_key(theta)
        if key in seen:
            continue
        seen.add(key)
        out.append((list(theta), float(r)))
    if len(out) > cap:
        keep = sorted(range(len(out)), key=lambda i: out[i][1],
                      reverse=True)[:cap]
        out = [out[i] for i in sorted(keep)]
    return out


@dataclass
class BayesianMetaOptimizer:
    """Suggest → observe loop.  ``suggest()`` returns the next Θ to try;
    ``observe(theta, reward)`` updates the posterior."""

    bounds: np.ndarray = field(default_factory=lambda: DEFAULT_BOUNDS.copy())
    n_init: int = 4                  # random (Sobol-ish) warmup trials
    candidates: int = 512            # acquisition sweep size
    xi: float = 0.01                 # EI exploration margin
    seed: int = 0
    max_queues: int = 32

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.trials: list[Trial] = []
        self.gp = GaussianProcess()

    # ---- unit-cube <-> Θ ------------------------------------------------

    def _to_unit(self, theta: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (theta - lo) / (hi - lo)

    def _from_unit(self, u: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + u * (hi - lo)

    # ---- public API -------------------------------------------------------

    def suggest(self) -> MetaParams:
        """Next meta-parameters to try (random warmup, then expected improvement)."""
        d = len(self.bounds)
        if len(self.trials) == 0:
            # Start from the hand-tuned default — anchors the search where a
            # human operator would start (the paper's baseline policy).
            return MetaParams(max_queues=self.max_queues)
        if len(self.trials) < self.n_init:
            u = self.rng.random(d)
            return MetaParams.from_vector(self._from_unit(u),
                                          max_queues=self.max_queues)
        X = np.stack([self._to_unit(t.theta) for t in self.trials])
        y = np.asarray([t.reward for t in self.trials])
        self.gp.fit(X, y)
        best = y.max()
        U = self.rng.random((self.candidates, d))
        mu, sd = self.gp.predict(U)
        z = (mu - best - self.xi) / sd
        ei = (mu - best - self.xi) * _norm_cdf(z) + sd * _norm_pdf(z)
        u_star = U[int(np.argmax(ei))]
        return MetaParams.from_vector(self._from_unit(u_star),
                                      max_queues=self.max_queues)

    def observe(self, meta: MetaParams, reward: float) -> None:
        """Record the reward obtained by a trial."""
        self.trials.append(Trial(np.asarray(meta.as_vector(), dtype=np.float64),
                                 float(reward)))

    # ---- fleet-level posterior sharing ------------------------------------

    def export_trials(self) -> list[tuple[list[float], float]]:
        """Serializable posterior: every (Θ, reward) observation so far.
        Consumed by the fleet policy store, which pools trials across
        replicas into one shared surrogate."""
        return [(t.theta.tolist(), float(t.reward)) for t in self.trials]

    def merge_trials(self, trials, cap: int = 256) -> int:
        """Fold externally observed (Θ, reward) pairs — e.g. the fleet
        store's pooled posterior — into this optimizer's trial history via
        the shared ``pool_trials`` semantics (first-seen dedup, lowest-
        reward capped, order otherwise preserved so ``converged`` keeps its
        recency semantics).  Returns the number of trials added."""
        before = {_trial_key(t.theta) for t in self.trials}
        pooled = pool_trials(self.export_trials(), trials, cap)
        self.trials = [Trial(np.asarray(t, dtype=np.float64), r)
                       for t, r in pooled]
        return sum(1 for t, _ in pooled if _trial_key(t) not in before)

    @property
    def best(self) -> MetaParams | None:
        """Best meta-parameters observed so far."""
        if not self.trials:
            return None
        t = max(self.trials, key=lambda t: t.reward)
        return MetaParams.from_vector(t.theta, max_queues=self.max_queues)

    @property
    def best_reward(self) -> float:
        """Best reward observed so far."""
        return max((t.reward for t in self.trials), default=-np.inf)

    def converged(self, window: int = 3, tol: float = 0.02) -> bool:
        """Paper App. B: reward stabilizes after 5–8 trials; we declare
        convergence when the best reward improved < tol over the last
        ``window`` trials."""
        if len(self.trials) < self.n_init + window:
            return False
        rewards = [t.reward for t in self.trials]
        prev_best = max(rewards[:-window])
        return self.best_reward - prev_best < tol * max(abs(prev_best), 1e-9)
