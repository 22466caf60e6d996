"""Density-weighted, context-aware scoring (paper §4.1 / §4.4.1, Eq. 1/4).

    Φ(r, q) = qf · ( w_base + w_urg · cs + w_fair · log(b+1) )

with
    cs = W_t / C_prefill(b)      compute-normalized urgency,
    qf = q_i / (b̄ + 1)           SJF-inspired queue factor,
    b  = prompt length of the head-of-line request,
    b̄  = queue mean prompt length.

Weights are *context-aware*: produced by a linear meta-policy on the queue's
mean prompt length, e.g.  w_urg(b̄_q) = a_u · (b̄_q / B_norm) + b_u  — slopes
and intercepts are the meta-parameters Θ tuned by the Bayesian optimizer.

Conventions (these matter for the SJF behaviour and are unit-tested):

* Queue indices q_i count from *k down to 1* with q_1 = the longest-prompt
  queue...  The paper defines qf = q_i/(b̄+1) and says it "prioritizes
  shorter jobs".  With q_i ascending in prompt length the numerator would
  *favor long queues*; dividing by (b̄+1) restores the short bias.  We use
  ascending indices exactly as written — qf = (i+1)/(b̄+1) — since the
  (b̄+1) denominator dominates and yields the SJF bias the paper describes.
* Starvation freedom (Thm A.1): cs grows without bound in wait time, so any
  positive w_urg guarantees eventual scheduling.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import log
from typing import Callable

from .types import MetaParams, Request, ScoringWeights


def weights_for_queue(meta: MetaParams, queue_mean_len: float) -> ScoringWeights:
    """Meta-policy π(b̄_q) → per-queue scoring weights (§4.4.1)."""
    x = queue_mean_len / max(meta.b_norm, 1.0)
    return ScoringWeights(
        w_base=max(0.0, meta.a_base * x + meta.b_base),
        w_urgency=max(1e-6, meta.a_urg * x + meta.b_urg),    # >0: Thm A.1
        w_fairness=max(0.0, meta.a_fair * x + meta.b_fair),
    )


@dataclass
class QueueProfile:
    """The per-queue statistics the scorer consumes (q.profile in Alg. 1)."""

    index: int                  # position in ascending-length queue order
    mean_len: float             # b̄_q — running mean of routed prompt lengths
    weights: ScoringWeights


def compute_score(req: Request, profile: QueueProfile, now: float,
                  c_prefill: Callable[[float], float]) -> float:
    """Score the head-of-line request of one queue (Eq. 1 / Eq. 4).

    ``b`` is the request's *work* length: the effective prompt length
    (uncached suffix, KV plane) plus the prediction plane's decode-side
    estimate in prefill-equivalent tokens.  A long prompt with a hot
    cached prefix competes like the short job it actually is; a short
    prompt predicted to generate 1k tokens competes like the long job it
    actually is.  Identical to raw ``prompt_len`` whenever ``cached_len``
    is 0 and no prediction is stamped."""
    b = req.work_len
    w = profile.weights
    wait = req.wait_time(now)
    cost = max(c_prefill(b), 1e-9)
    cs = wait / cost                                   # compute score
    qf = (profile.index + 1.0) / (profile.mean_len + 1.0)  # queue factor
    return qf * (w.w_base + w.w_urgency * cs + w.w_fairness * log(b + 1.0))


def score_decomposition(req: Request, profile: QueueProfile, now: float,
                        c_prefill: Callable[[float], float]) -> dict:
    """Expose each term for diagnostics / Figure-2-style plots."""
    b = req.work_len
    w = profile.weights
    cost = max(c_prefill(b), 1e-9)
    cs = req.wait_time(now) / cost
    qf = (profile.index + 1.0) / (profile.mean_len + 1.0)
    return {
        "qf": qf,
        "cs": cs,
        "base": w.w_base,
        "urgency": w.w_urgency * cs,
        "fairness": w.w_fairness * log(b + 1.0),
        "total": qf * (w.w_base + w.w_urgency * cs + w.w_fairness * log(b + 1.0)),
    }
