"""Heavy-tailed decode-length workloads (the predictor's proving ground).

The paper's mixed workload is bimodal in *prompt* length with short
geometric outputs — exactly the regime where prompt-keyed EWSJF already
wins.  The prediction plane earns its keep when output lengths are
heavy-tailed and uncorrelated with prompt length: a small fraction of
requests carry most of the decode work, and nothing on the prompt side
gives them away.  :class:`HeavyTailDecodeSpec` generates that traffic,
with sessions (so the empirical per-session posterior has signal to
learn), a drift knob (sessions swap output regimes mid-run — the
calibration-drift axis), and an adversarial mode (the longest generations
hide behind the *shortest* prompts, the worst case for prompt-keyed SJF).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.types import Request


@dataclass
class HeavyTailDecodeSpec:
    """Sessionful traffic where a few sessions own the decode tail.

    ``tail_session_frac`` of sessions are "tail" sessions whose requests
    draw long uniform outputs (``tail_output_range``); the rest draw short
    geometric outputs (``body_output_mean``).  Per-request membership is
    sticky within a session, which is what makes output length *learnable*
    from session history.  With ``drift_time`` set, the tail role *moves*
    to a disjoint, equally-sized set of sessions for arrivals after that
    time — aggregate load stays stationary (this is a calibration drift,
    not a load spike) while every trained posterior involved is suddenly
    wrong-signed.  With ``adversarial`` set, tail requests also draw their
    prompts from the short end, defeating any prompt-length heuristic."""

    n_requests: int = 2000
    arrival_rate: float = 12.0
    n_sessions: int = 64
    tail_session_frac: float = 0.12
    prompt_range: tuple[int, int] = (48, 512)
    body_output_mean: float = 24.0
    body_output_cap: int = 96
    tail_output_range: tuple[int, int] = (512, 1024)
    drift_time: float | None = None
    adversarial: bool = False
    seed: int = 0

    def generate(self) -> list[Request]:
        """Materialize the arrival sequence (deterministic in ``seed``)."""
        rng = np.random.default_rng(self.seed)
        n = self.n_requests
        arrivals = np.cumsum(rng.exponential(1.0 / self.arrival_rate, size=n))
        n_tail_sessions = max(int(round(self.n_sessions
                                        * self.tail_session_frac)), 1)
        # Sessions [0, n_tail_sessions) are the tail sessions pre-drift.
        sessions = rng.integers(0, self.n_sessions, size=n)
        prompts = rng.integers(self.prompt_range[0], self.prompt_range[1] + 1,
                               size=n)
        body_outs = np.clip(
            rng.geometric(1.0 / self.body_output_mean, size=n),
            1, self.body_output_cap)
        tail_outs = rng.integers(self.tail_output_range[0],
                                 self.tail_output_range[1] + 1, size=n)
        reqs: list[Request] = []
        for i in range(n):
            sid = int(sessions[i])
            is_tail = sid < n_tail_sessions
            if self.drift_time is not None \
                    and float(arrivals[i]) >= self.drift_time:
                # Regime remap: sessions [n_tail, 2·n_tail) carry the tail
                # now; the former tail sessions turn body.  Same aggregate
                # tail fraction before and after.
                is_tail = n_tail_sessions <= sid < 2 * n_tail_sessions
            out = int(tail_outs[i] if is_tail else body_outs[i])
            plen = int(prompts[i])
            if self.adversarial and is_tail:
                plen = int(self.prompt_range[0])
            reqs.append(Request(prompt_len=plen,
                                arrival_time=float(arrivals[i]),
                                max_new_tokens=out,
                                session_id=sid))
        return reqs

    def tail_fraction(self) -> float:
        """Nominal fraction of requests that are tail (pre-drift)."""
        return max(int(round(self.n_sessions * self.tail_session_frac)),
                   1) / float(self.n_sessions)
