"""Empirical output-length posteriors, learned online in the DES.

No hidden-state head exists in the simulator, so the learnable signal is
the empirical distribution of *observed* output lengths, conditioned on
what the scheduler can see at ingest: the session (multi-turn/agentic
traffic has strongly autocorrelated output lengths) and the prompt-length
bucket (short "command" prompts and long "analysis" prompts draw from
different regimes).  :class:`EmpiricalLengthPredictor` keeps a bounded
sample window per key — session first, prompt bucket next, global last —
and answers from the most specific key with enough evidence.

Calibration contract:

* **Cold keys abstain.**  Below ``min_obs`` samples at every level the
  predictor returns None and scheduling stays length-blind — no made-up
  priors.
* **Bounded windows forget.**  Each key keeps at most ``cap`` recent
  samples, so drift (a session switching from chat to code generation)
  washes out of the posterior in O(cap) observations.
* **Fleet merge is sample pooling.**  ``export_state`` publishes the raw
  windows (bounded, so control-plane payloads stay small);
  :func:`merge_states` pools them per key with the same cap, and
  ``merge_state`` lets a warm-starting replica adopt the pooled posterior
  wholesale where it has no local evidence, or blend where it does.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from ..core.types import Request
from .predictor import LengthPrediction, LengthPredictor

_GLOBAL_KEY = "g"


def _bucket_key(prompt_len: int) -> str:
    """Power-of-two prompt-length bucket key ("b5" = 16..31 tokens)."""
    return f"b{max(int(prompt_len), 1).bit_length()}"


def _session_key(session_id) -> Optional[str]:
    """Key for per-session posteriors; None when the request is sessionless."""
    return None if session_id is None else f"s{int(session_id)}"


def merge_states(states, per_key_cap: int = 256) -> dict:
    """Pool several exported posterior states into one fleet posterior.

    Concatenates each key's sample windows across ``states`` (later states
    win the tail — callers pass freshest last) and keeps the most recent
    ``per_key_cap`` samples per key.  Pure function used by the
    PolicyStore merge step."""
    pooled: dict = {}
    for state in states:
        if not state:
            continue
        for key, samples in state.get("keys", {}).items():
            pooled.setdefault(key, []).extend(float(s) for s in samples)
    return {"keys": {k: v[-per_key_cap:] for k, v in pooled.items() if v}}


class EmpiricalLengthPredictor(LengthPredictor):
    """Per-session / per-prompt-bucket empirical output-length posteriors.

    ``predict`` walks session → prompt bucket → global and answers from
    the first key holding at least ``min_obs`` samples; otherwise it
    abstains.  ``observe`` (called by replicas at finish) appends the true
    output length to every matching key's window.  ``remaining_work``
    answers the decode-time question E[L - g | L > g] from the same
    window, so in-flight requests that outlive the posterior's median get
    progressively larger remaining-work estimates (the long-tail demotion
    signal)."""

    def __init__(self, min_obs: int = 8, cap: int = 256, recent: int = 16,
                 cost=None, decode_batch_hint: int = 64):
        """``min_obs`` is the abstain threshold per key; ``cap`` bounds each
        key's sample window (drift forgetting + control-plane payload);
        ``recent`` is the slice of the window point estimates are computed
        from — the median of the last ``recent`` samples flips within
        ``recent``/2 observations of a regime change, where the full-window
        mean would stay wrong-signed for O(cap) observations."""
        super().__init__(cost=cost, decode_batch_hint=decode_batch_hint)
        self.min_obs = int(min_obs)
        self.cap = int(cap)
        self.recent = int(recent)
        self._windows: dict[str, deque] = {}
        self.n_observed = 0

    # ---- learning --------------------------------------------------------

    def _keys_for(self, req: Request) -> list[str]:
        keys = []
        sk = _session_key(req.session_id)
        if sk is not None:
            keys.append(sk)
        keys.append(_bucket_key(req.prompt_len))
        keys.append(_GLOBAL_KEY)
        return keys

    def observe(self, req: Request, now: float) -> None:
        """Record a finished request's true output length under all keys."""
        out = float(req.generated if req.generated > 0 else req.max_new_tokens)
        for key in self._keys_for(req):
            self._windows.setdefault(key, deque(maxlen=self.cap)).append(out)
        self.n_observed += 1

    # ---- prediction ------------------------------------------------------

    def _window_for(self, req: Request):
        for key in self._keys_for(req):
            w = self._windows.get(key)
            if w is not None and len(w) >= self.min_obs:
                return w
        return None

    def predict(self, req: Request, now: float) -> Optional[LengthPrediction]:
        """Posterior point estimate and quantiles from the most specific
        warm key.  The point estimate is the *median of the recent slice* —
        robust to the heavy tail (one 1k-token outlier must not demote a
        whole session) and fast to flip after regime drift; the quantiles
        come from the recent slice for the same reason."""
        w = self._window_for(req)
        if w is None:
            return None
        arr = np.asarray(w, dtype=np.float64)[-self.recent:]
        return LengthPrediction(
            expected=float(np.quantile(arr, 0.5)),
            p50=float(np.quantile(arr, 0.5)),
            p90=float(np.quantile(arr, 0.9)),
            n=int(arr.size))

    def remaining_work(self, req: Request, generated: int) -> float:
        """Conditional expected remaining tokens E[L - g | L > g], from the
        recent slice (drift robustness, as in ``predict``)."""
        w = self._window_for(req)
        g = float(generated)
        if w is None:
            return super().remaining_work(req, generated)
        arr = np.asarray(w, dtype=np.float64)[-self.recent:]
        tail = arr[arr > g]
        if tail.size == 0:
            # Outlived every sample: assume it keeps going like the
            # longest observed output did beyond the median.
            return max(float(arr.max()) - float(np.quantile(arr, 0.5)), 1.0)
        return max(float(tail.mean()) - g, 1.0)

    # ---- fleet state -----------------------------------------------------

    def export_state(self) -> Optional[dict]:
        """Bounded JSON-able sample windows for PolicyStore publication."""
        if not self._windows:
            return None
        return {"keys": {k: [float(s) for s in w]
                         for k, w in self._windows.items() if w},
                "n_observed": self.n_observed}

    def merge_state(self, state: dict) -> None:
        """Absorb a pooled fleet posterior: adopt keys we have no local
        evidence for; blend (pool + recency cap) keys we do."""
        if not state:
            return
        for key, samples in state.get("keys", {}).items():
            w = self._windows.get(key)
            if w is None or not w:
                self._windows[key] = deque(
                    (float(s) for s in samples[-self.cap:]), maxlen=self.cap)
            else:
                merged = [float(s) for s in samples] + list(w)
                self._windows[key] = deque(merged[-self.cap:], maxlen=self.cap)
