"""Output-length prediction protocol (predicted-length scheduling plane).

EWSJF scores on *prompt*-side effective work; the decode side is blind
until tokens stream out, so a short prompt with a 4k-token generation is
"shortest job" right up until it clogs the decode batch.  This module
defines the pluggable ``LengthPredictor`` protocol that closes that gap:

* ``predict(req, now)`` returns a :class:`LengthPrediction` (expected
  output tokens + quantiles + sample count) or **None to abstain** —
  abstention is the calibration contract's escape hatch: a predictor that
  does not know must say so, and every consumer (scoring, routing,
  admission, preemption) falls back to the length-blind arithmetic for
  that request.  A fleet with a predictor wired but abstaining on every
  request is bit-identical to a fleet with no predictor at all.
* ``annotate(req, now)`` stamps the prediction onto the request as an
  *additive* prefill-equivalent term (``Request.predicted_extra``) so
  ``Request.work_len = effective_len + predicted_extra`` composes with
  the KV plane's cached-prefix discount (which mutates ``cached_len``
  after ingest) without going stale.
* ``remaining_work(req, generated)`` is the decode-time signal: expected
  output tokens still to come given ``generated`` so far.  Replicas use
  it to pick preemption victims (demote the request predicted to run
  longest — Gittins-style, smallest expected-remaining-first keeps KV).
* ``export_state()`` / ``merge_state()`` plug into the fleet
  ``PolicyStore`` epoch protocol so empirical posteriors learned on one
  replica warm-start scale-ups and converge fleet-wide.

The conversion from decode tokens to prefill-equivalent tokens is
batch-amortized (:func:`work_equivalent_extra`): a solo decode step is
weights-streaming-bound (~50x a prefill token), but schedulers see decode
amortized over the running batch, so the honest exchange rate uses a
``decode_batch_hint`` — the typical decode batch size — not batch=1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.types import Request


@dataclass(frozen=True)
class LengthPrediction:
    """One output-length prediction: point estimate plus uncertainty.

    ``expected`` is the mean predicted output-token count; ``p50``/``p90``
    are posterior quantiles (equal to ``expected`` for point predictors);
    ``n`` is the evidence count behind the estimate (0 for oracles)."""

    expected: float
    p50: float
    p90: float
    n: int = 0


def work_equivalent_extra(expected_out: float, prompt_len: float,
                         cost=None, decode_batch_hint: int = 64) -> float:
    """Convert ``expected_out`` decode tokens into prefill-equivalent tokens.

    With a :class:`~repro_torch.core.cost_model.CostModel`, charge the
    batch-amortized decode seconds for the request's generation (batch
    ``decode_batch_hint``, average context ``prompt_len + expected_out/2``)
    and divide by the per-token prefill cost at a reference length; without
    one, fall back to a 1:1 token exchange.  Never negative."""
    if expected_out <= 0.0:
        return 0.0
    if cost is None:
        return float(expected_out)
    b = max(int(decode_batch_hint), 1)
    avg_ctx = max(prompt_len + expected_out / 2.0, 1.0)
    per_decode_s = cost.decode_step_time(b, int(b * avg_ctx)) / b
    ref = 512.0
    per_prefill_s = max(cost.c_prefill(ref) / ref, 1e-12)
    return max(expected_out * per_decode_s / per_prefill_s, 0.0)


def gittins_index(eos_prob: float, horizon: int = 14,
                  max_steps: int = 512) -> float:
    """Gittins-style decode priority from a per-step EOS probability.

    ``P(finish within the next ``horizon`` steps) / E[remaining steps]``
    under a geometric stopping model — the ``InferSchedule`` ranking
    (SNIPPETS 1–2): requests likely to finish soon and cheap to finish
    rank high; long-expected-remaining requests rank low (demotion
    candidates).  ``eos_prob`` is clamped to (1e-6, 1.0)."""
    p = min(max(float(eos_prob), 1e-6), 1.0)
    p_next = 1.0 - (1.0 - p) ** horizon
    keep = 1.0 - p
    expect_remaining = min(keep / p, float(max_steps))
    return p_next / max(expect_remaining, 1e-9)


class LengthPredictor:
    """Base class for output-length predictors (abstains on everything).

    Subclasses override :meth:`predict` (and optionally :meth:`observe`,
    :meth:`export_state`, :meth:`merge_state`).  The base class implements
    the consumer-facing plumbing — :meth:`annotate` and
    :meth:`remaining_work` — entirely off the stamps, so the calibration
    contract lives in one place.  The base class itself is a usable
    "abstain predictor": wiring it everywhere is bit-identical to wiring
    nothing (property-tested)."""

    def __init__(self, cost=None, decode_batch_hint: int = 64):
        """``cost`` is an optional CostModel for the decode→prefill token
        exchange rate; ``decode_batch_hint`` is the typical decode batch
        size used to amortize it."""
        self.cost = cost
        self.decode_batch_hint = int(decode_batch_hint)

    # ---- subclass surface ------------------------------------------------

    def predict(self, req: Request, now: float) -> Optional[LengthPrediction]:
        """Predict ``req``'s output length, or None to abstain."""
        return None

    def observe(self, req: Request, now: float) -> None:
        """Ingest a finished request's true output length (online learning)."""

    def export_state(self) -> Optional[dict]:
        """JSON-able posterior state for PolicyStore publication (None if
        this predictor has nothing to share)."""
        return None

    def merge_state(self, state: dict) -> None:
        """Absorb a pooled fleet posterior published by the PolicyStore."""

    # ---- consumer-facing plumbing ---------------------------------------

    def annotate(self, req: Request, now: float) -> None:
        """Stamp ``predicted_output`` / ``predicted_extra`` onto ``req``.

        Abstention leaves both stamps None, which makes ``req.work_len``
        degrade to ``effective_len`` exactly."""
        pred = self.predict(req, now)
        if pred is None:
            return
        req.predicted_output = float(pred.expected)
        req.predicted_extra = work_equivalent_extra(
            pred.expected, float(req.prompt_len), self.cost,
            self.decode_batch_hint)

    def remaining_work(self, req: Request, generated: int) -> float:
        """Expected output tokens still to come after ``generated``.

        Base implementation reads the ``predicted_output`` stamp (falling
        back to ``max_new_tokens``); subclasses with conditional
        posteriors override with E[L - g | L > g]."""
        total = (req.predicted_output if req.predicted_output is not None
                 else float(req.max_new_tokens))
        return max(total - float(generated), 1.0)


class OracleNoisePredictor(LengthPredictor):
    """Deterministic oracle with controllable log-normal error.

    The DES knows each request's true output length (``max_new_tokens``),
    so this predictor sweeps the calibration axis directly: predicted =
    true · exp(N(bias, sigma²)), with the noise drawn from a per-request
    deterministic stream (seeded by ``request_id``) so repeated runs — and
    repeated :meth:`predict` calls on one request — agree bit-for-bit.

    * ``sigma`` — calibration error (0 = perfect oracle);
    * ``bias`` — systematic mis-calibration (drift axis): e.g. ``bias =
      -1.0`` models a predictor trained before the workload drifted long.
    """

    def __init__(self, sigma: float = 0.0, bias: float = 0.0, seed: int = 0,
                 cost=None, decode_batch_hint: int = 64):
        """``sigma``/``bias`` parametrize log-normal multiplicative error;
        ``seed`` decorrelates the per-request noise streams."""
        super().__init__(cost=cost, decode_batch_hint=decode_batch_hint)
        self.sigma = float(sigma)
        self.bias = float(bias)
        self.seed = int(seed)

    def predict(self, req: Request, now: float) -> Optional[LengthPrediction]:
        """True output length under multiplicative log-normal noise."""
        true = float(req.max_new_tokens)
        if self.sigma <= 0.0 and self.bias == 0.0:
            return LengthPrediction(true, true, true, n=0)
        rng = np.random.default_rng(
            (self.seed << 32) ^ (int(req.request_id) & 0xFFFFFFFF))
        noise = float(rng.normal(self.bias, self.sigma)) if self.sigma > 0.0 \
            else self.bias
        est = max(true * float(np.exp(noise)), 1.0)
        spread = float(np.exp(1.2816 * self.sigma))   # z_{0.90}
        return LengthPrediction(est, est, est * spread, n=0)
