"""Core datatypes shared by the EWSJF scheduler stack.

The scheduler is a host-side control layer (as in the paper, where it sits
above vLLM's execution engine), so these are plain Python dataclasses, not
pytrees.  The jit'd engine below consumes the batches this layer emits.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional

_REQUEST_COUNTER = itertools.count()


class RequestState(Enum):
    """Lifecycle state of a request inside the serving system."""
    WAITING = "waiting"        # in a scheduler queue, not yet admitted
    RUNNING_PREFILL = "prefill"
    RUNNING_DECODE = "decode"
    PREEMPTED = "preempted"    # evicted (KV pressure); will be re-enqueued
    FINISHED = "finished"
    FAILED = "failed"


class TerminalState(Enum):
    """How a request's life ended — the *one* classification every plane
    agrees on.  Stamped exactly once (``Request.terminal``) at the point a
    request leaves the system, recorded by the tracer and counted in the
    metrics registry (``requests_terminal_total{state,slo_class}``), so
    the per-component shed/dropped counters can no longer diverge."""

    FINISHED = "finished"              # generated all tokens
    SHED = "shed"                      # rejected by admission / load shedding
    DEADLINE_DROPPED = "deadline_dropped"  # admitted, but missed its deadline


@dataclass
class Request:
    """One inference request as seen by the admission scheduler.

    ``prompt_len`` is the *input-side* signal EWSJF schedules on (the paper
    deliberately avoids output-length predictors, §2.3).
    """

    prompt_len: int
    arrival_time: float = 0.0
    max_new_tokens: int = 128
    request_id: int = field(default_factory=lambda: next(_REQUEST_COUNTER))
    prompt_tokens: Optional[Any] = None     # int array when actually executing
    priority_class: int = 0                 # optional operator hint (unused by EWSJF)

    # KV plane (prefix reuse).  ``prompt_hashes`` is the chained token-block
    # hash chain of the prompt (kvplane.radix) — None means no reuse is
    # possible.  ``cached_len`` is the router's estimate of prefix tokens
    # already resident on the assigned replica; the scheduler stack scores
    # and queues on the *effective* length (the uncached suffix), since
    # that is the work the request actually costs.  ``prefix_fetch`` is a
    # planned remote-prefix transfer (kvplane topology), set by a
    # prefix-aware router and consumed at dispatch.
    prompt_hashes: Optional[tuple] = None
    cached_len: int = 0
    prefix_fetch: Optional[Any] = None

    # Prediction plane (predicted-length scheduling).  ``predicted_output``
    # is a predictor's expected output-token count for this request;
    # ``predicted_extra`` is that estimate converted to *prefill-equivalent*
    # tokens (batch-amortized decode seconds / per-token prefill seconds),
    # kept additive so it composes with the KV plane's ``cached_len``
    # discount, which is stamped later by the router.  Both stay None when
    # no predictor is wired or the predictor abstains — ``work_len`` then
    # degrades to ``effective_len`` bit-for-bit.  ``session_id`` groups
    # requests from one conversation/agent loop (the empirical predictor's
    # strongest conditioning key); None for sessionless traffic.
    predicted_output: Optional[float] = None
    predicted_extra: Optional[float] = None
    session_id: Optional[int] = None

    # Lifecycle bookkeeping (filled in by the engine / simulator).
    state: RequestState = RequestState.WAITING
    terminal: Optional[TerminalState] = None  # stamped once, at exit
    # SLO-class label cache, stamped by the observability plane on first
    # classification (arrival) and reused at dispatch/finish so the label
    # is computed once per request.  Never read by scheduling code.
    slo_class: Optional[str] = None
    enqueue_time: float = 0.0               # when routed into a queue
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    generated: int = 0
    queue_id: Optional[int] = None
    preemptions: int = 0

    def wait_time(self, now: float) -> float:
        """Seconds since arrival, as of ``now``."""
        return max(0.0, now - self.arrival_time)

    @property
    def effective_len(self) -> float:
        """Prompt tokens that must actually be prefilled (the uncached
        suffix).  Equal to ``prompt_len`` whenever the KV plane is off
        (``cached_len`` 0), so every effective-length consumer degrades to
        the pre-KV-plane arithmetic bit-for-bit.  At least one token is
        always recomputed (a fully cached prompt still runs a 1-token
        prefill to produce its first logit)."""
        if self.cached_len <= 0:
            return float(self.prompt_len)
        return float(max(self.prompt_len - self.cached_len, 1))

    @property
    def work_len(self) -> float:
        """Predicted *total* effective work in prefill-equivalent tokens:
        the uncached prompt suffix plus the predictor's decode-side
        estimate (``predicted_extra``).  This is what EWSJF scores and
        queues on when a prediction plane is wired; with no prediction
        stamp it is exactly ``effective_len``, so every consumer degrades
        to the length-blind arithmetic bit-for-bit."""
        e = self.effective_len
        if self.predicted_extra is None:
            return e
        return e + self.predicted_extra

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token in seconds, or None before the first token."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def e2e_latency(self) -> Optional[float]:
        """Arrival-to-finish seconds, or None while unfinished."""
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time


@dataclass(frozen=True)
class QueueBounds:
    """Closed prompt-length interval [lo, hi] owned by one queue."""

    lo: float
    hi: float

    def contains(self, b: float) -> bool:
        """True when length ``b`` lies inside ``[lo, hi]``."""
        return self.lo <= b <= self.hi

    @property
    def width(self) -> float:
        """Width of the length range."""
        return self.hi - self.lo

    @property
    def center(self) -> float:
        """Midpoint of the length range."""
        return 0.5 * (self.lo + self.hi)


@dataclass
class ScoringWeights:
    """Instantiated weights for one queue (Eq. 1 / Eq. 4)."""

    w_base: float = 1.0
    w_urgency: float = 1.0
    w_fairness: float = 1.0


@dataclass
class MetaParams:
    """Meta-policy parameters Θ tuned by the Bayesian optimizer (§4.4.2).

    Each scoring weight is produced by a linear map on the queue's mean
    prompt length  w(b̄_q) = a·b̄_q/B_norm + b , with B_norm a fixed length
    normalizer so the slopes are O(1).
    """

    a_urg: float = -0.5
    b_urg: float = 1.5
    a_fair: float = 0.8
    b_fair: float = 0.2
    a_base: float = 0.0
    b_base: float = 1.0
    alpha_split: float = 3.0        # Refine-and-Prune significance ratio α (Eq. 2)
    max_queues: int = 32            # Stage-3 pruning budget
    b_norm: float = 2048.0          # length normalizer for the meta-policy

    def as_vector(self) -> list[float]:
        """The parameters as a flat vector (meta-optimizer space)."""
        return [self.a_urg, self.b_urg, self.a_fair, self.b_fair,
                self.a_base, self.b_base, self.alpha_split]

    @staticmethod
    def from_vector(v, max_queues: int = 32, b_norm: float = 2048.0) -> "MetaParams":
        """Parameters from a flat vector (inverse of ``as_vector``)."""
        return MetaParams(a_urg=float(v[0]), b_urg=float(v[1]),
                          a_fair=float(v[2]), b_fair=float(v[3]),
                          a_base=float(v[4]), b_base=float(v[5]),
                          alpha_split=float(v[6]),
                          max_queues=max_queues, b_norm=b_norm)


@dataclass
class SchedulerPolicy:
    """One complete policy emitted by the strategic loop (§3.1):
    queue structure (interval boundaries) + scoring meta-parameters."""

    boundaries: list[QueueBounds]
    meta: MetaParams

    def n_queues(self) -> int:
        """Number of queues in the policy."""
        return len(self.boundaries)


@dataclass
class QueueSnapshot:
    """Read-only view of one scheduler queue, exported for cluster routing
    (the router must see queue *structure*, not just totals)."""

    queue_id: int
    index: int                      # position in ascending-length order
    lo: float
    hi: float
    depth: int                      # waiting requests
    tokens: int                     # waiting prompt tokens
    mean_len: float                 # b̄_q
    head_len: Optional[float] = None
    head_wait: float = 0.0
    head_score: float = 0.0         # density-weighted score of the head

    def contains(self, length: float) -> bool:
        """True when ``length`` falls inside this queue's range."""
        return self.lo <= length < self.hi or (
            self.hi == float("inf") and length >= self.lo)


@dataclass
class SchedulerSnapshot:
    """Cheap introspection view of a BaseScheduler, consumed by cluster-level
    routers.  Totals (`waiting`, `waiting_tokens`) support least-loaded
    policies; the per-queue list supports EWSJF-aware routing."""

    policy: str
    waiting: int
    waiting_tokens: int
    queues: list["QueueSnapshot"] = field(default_factory=list)

    def queue_for(self, length: float) -> Optional["QueueSnapshot"]:
        """The queue a request of ``length`` would route into (interval
        containment; falls back to the nearest queue by center)."""
        for q in self.queues:
            if q.contains(length):
                return q
        if not self.queues:
            return None
        return min(self.queues,
                   key=lambda q: abs(0.5 * (q.lo + min(q.hi, 2 * length))
                                     - length))


@dataclass
class BatchPlan:
    """What the tactical loop hands the engine for one step (Alg. 1 output)."""

    requests: list[Request]
    primary_queue: Optional[int] = None
    backfill_queues: list[int] = field(default_factory=list)
    total_tokens: int = 0
    padded_tokens: int = 0          # bucket-padded token count (TPU adaptation)

    @property
    def padding_waste(self) -> float:
        """Share of the batch's padded tokens that are padding."""
        if self.padded_tokens <= 0:
            return 0.0
        return 1.0 - self.total_tokens / self.padded_tokens
