"""Monitor — the strategic loop's data-collection half (§3.1).

Collects metadata from completed requests into (a) a large historical window
for offline Refine-and-Prune runs and (b) a compact real-time window for
online adjustments, and computes the reward terms the Bayesian
meta-optimizer consumes (Eq. 5):

    R(Θ) = λ1·C + λ2·L − λ3·S − λ4·U

    C  queue compactness   — mean within-queue length homogeneity
    L  load balance        — negative imbalance across queues (higher=better)
    S  queue proliferation — number of active queues (penalty)
    U  user experience     — latency penalties (mean TTFT of short requests,
                             p95 e2e latency)
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from .types import Request


@dataclass
class RewardWeights:
    """Weights of the reward terms the meta-optimizer maximizes."""
    lam_compact: float = 1.0
    lam_balance: float = 0.5
    lam_spread: float = 0.05
    lam_ux: float = 2.0


@dataclass
class WindowStats:
    """Throughput and latency statistics over one monitoring window."""
    n: int
    mean_ttft_short: float
    mean_ttft: float
    p95_latency: float
    throughput_tokens: float
    throughput_reqs: float


class Monitor:
    """Arrival history and a window of finished requests (reward input)."""
    def __init__(self, history_cap: int = 200_000, window_cap: int = 4096,
                 short_threshold: float = 256.0):
        self.history: deque[float] = deque(maxlen=history_cap)   # prompt lengths
        self.window: deque[Request] = deque(maxlen=window_cap)   # recent finished
        self.short_threshold = short_threshold
        self.total_finished = 0
        self.total_tokens_out = 0
        # True arrival count (the history deque is capped): the fleet policy
        # store weighs each replica's pooled sample by this.
        self.total_arrivals = 0

    # ---- ingestion ------------------------------------------------------

    def observe_arrival(self, req: Request) -> None:
        """Record one arrival's work length in the history."""
        # The strategic loop partitions on *work* lengths (KV + prediction
        # planes): queue boundaries should separate requests by the work
        # they cost — uncached prefill plus predicted decode — not the
        # tokens they carry.  Equal to prompt_len when neither plane has
        # stamped the request.
        self.history.append(req.work_len)
        self.total_arrivals += 1

    def observe_finish(self, req: Request) -> None:
        """Record one finished request."""
        self.window.append(req)
        self.total_finished += 1
        self.total_tokens_out += req.generated

    # ---- strategic-loop reads --------------------------------------------

    def historical_lengths(self) -> np.ndarray:
        """Work lengths of every arrival still in the capped history."""
        return np.asarray(self.history, dtype=np.float64)

    def recent_lengths(self, n: int = 1024) -> np.ndarray:
        """Work lengths of the last ``n`` finished requests in the window."""
        reqs = list(self.window)[-n:]
        return np.asarray([r.work_len for r in reqs], dtype=np.float64)

    def window_stats(self, wall_elapsed: float) -> WindowStats:
        """TTFT, latency and throughput of the finished-request window over
        ``wall_elapsed`` seconds."""
        reqs = list(self.window)
        if not reqs:
            return WindowStats(0, 0.0, 0.0, 0.0, 0.0, 0.0)
        ttfts = np.asarray([r.ttft for r in reqs if r.ttft is not None])
        short_ttfts = np.asarray([r.ttft for r in reqs
                                  if r.ttft is not None
                                  and r.prompt_len <= self.short_threshold])
        lats = np.asarray([r.e2e_latency for r in reqs
                           if r.e2e_latency is not None])
        tokens = sum(r.generated for r in reqs)
        dt = max(wall_elapsed, 1e-9)
        return WindowStats(
            n=len(reqs),
            mean_ttft_short=float(short_ttfts.mean()) if len(short_ttfts) else 0.0,
            mean_ttft=float(ttfts.mean()) if len(ttfts) else 0.0,
            p95_latency=float(np.percentile(lats, 95)) if len(lats) else 0.0,
            throughput_tokens=tokens / dt,
            throughput_reqs=len(reqs) / dt,
        )


def reward_terms(queue_lengths: list[np.ndarray], stats: WindowStats,
                 n_queues: int) -> dict[str, float]:
    """Compute the four Eq. 5 terms from the observable state.

    ``queue_lengths`` — per-queue arrays of routed prompt lengths."""
    occupied = [q for q in queue_lengths if len(q) > 1]
    # C: compactness — 1/(1+mean within-queue coefficient of variation).
    if occupied:
        cvs = [float(np.std(q) / (np.mean(q) + 1e-9)) for q in occupied]
        compact = 1.0 / (1.0 + float(np.mean(cvs)))
    else:
        compact = 0.0
    # L: load balance — 1/(1+CV of queue populations).
    pops = np.asarray([len(q) for q in queue_lengths], dtype=np.float64)
    if pops.sum() > 0:
        balance = 1.0 / (1.0 + float(pops.std() / (pops.mean() + 1e-9)))
    else:
        balance = 0.0
    # S: proliferation penalty — normalized queue count.
    spread = float(n_queues)
    # U: user-experience penalty — short-request TTFT plus tail latency.
    ux = stats.mean_ttft_short + 0.1 * stats.p95_latency
    return {"compact": compact, "balance": balance, "spread": spread, "ux": ux}


def reward(terms: dict[str, float], w: RewardWeights,
           throughput_bonus: float = 0.0) -> float:
    """Eq. 5, plus an optional throughput bonus used when the optimizer is
    driven by the live engine (throughput is part of 'user experience' in
    the paper's deployment; keeping it explicit makes ablations cleaner)."""
    return (w.lam_compact * terms["compact"]
            + w.lam_balance * terms["balance"]
            - w.lam_spread * terms["spread"]
            - w.lam_ux * terms["ux"]
            + throughput_bonus)
