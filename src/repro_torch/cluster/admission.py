"""SLO-class admission control: shedding, re-admission, per-class budgets.

Once prefill and decode contend (Liu et al., fairness-aware chunked-prefill
scheduling), a saturated cluster must decide *which* work to refuse, not
just reorder it.  Requests are classified into SLO classes (interactive /
standard / batch by default); at arrival the controller compares the
cluster's best-case queue delay against the class TTFT budget and sheds
sheddable classes that cannot meet it.  Admitted requests may still be
deadline-dropped at dispatch time if they aged out while queued — dropping
at the last moment before prefill recovers the whole prompt cost.

Admission v2 (enabled by passing an :class:`AdmissionConfig`):

* **Bounded re-admission queue** — a rejected sheddable request is
  *deferred* instead of lost: it parks in a bounded retry queue and is
  re-offered (with backoff) while its deadline still allows, so a transient
  burst no longer permanently sheds work that the post-burst cluster could
  easily serve.  Permanent shed happens only on queue overflow or expiry.
* **Per-class token budgets** — under saturation each class is held to a
  weighted fair share of a configured token rate (FairBatching-style
  capacity shares rather than pure shed/keep): classes draw from per-class
  token buckets refilled proportionally to ``SLOClass.weight``, so a batch
  flood cannot starve standard traffic even before either misses its own
  TTFT budget.  Non-sheddable classes bypass budget enforcement.

Counting invariant (tested): a request increments ``admitted`` at most once
(on its final successful admission — ``readmitted`` additionally counts the
subset that were deferred first), and ``shed`` at most once (on permanent
rejection).  ``deferred`` / ``budget_denied`` are *event* counters.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from ..core.types import Request, RequestState, TerminalState


@dataclass(frozen=True)
class SLOClass:
    """One admission service class: TTFT budget, queueing deadline,
    shed priority, and fair-share weight."""
    name: str
    ttft_target: float          # seconds; admission budget for first token
    deadline: Optional[float]   # max queueing age before drop (None = never)
    priority: int = 0           # higher = more important (kept under load)
    sheddable: bool = True
    weight: float = 1.0         # fair-share weight for per-class budgets


DEFAULT_SLO_CLASSES = (
    SLOClass("interactive", ttft_target=1.0, deadline=10.0, priority=2,
             sheddable=False, weight=4.0),
    SLOClass("standard", ttft_target=5.0, deadline=60.0, priority=1,
             weight=2.0),
    SLOClass("batch", ttft_target=60.0, deadline=None, priority=0,
             weight=1.0),
)


def classify_by_length(req: Request, short_threshold: int = 256) -> str:
    """Default classifier: short prompts are interactive traffic, long
    prompts are batch-ish — matching the paper's mixed-workload split.
    ``Request.priority_class`` overrides when an operator set it: 0 means
    "no hint" (the dataclass default), 1=interactive, 2=standard,
    3+=batch."""
    if req.priority_class:
        return ("interactive", "standard", "batch")[
            min(req.priority_class, 3) - 1]
    return "interactive" if req.prompt_len <= short_threshold else "batch"


@dataclass
class AdmissionConfig:
    """Admission-v2 knobs.  Constructing a controller *without* a config
    reproduces the v1 one-shot shed behaviour (no retries, no budgets)."""

    shed_factor: float = 1.0
    # --- re-admission queue ---
    retry_capacity: int = 256        # bounded; overflow sheds permanently
    retry_backoff: float = 0.1       # seconds between attempts per request
    retry_ttl: float = 30.0          # retry window for deadline-None classes
    # --- per-class token budgets (0 disables, unless adaptive_refill) ---
    token_budget_per_s: float = 0.0  # cluster token capacity shared by weight
    budget_window: float = 1.0       # bucket burst horizon (seconds of rate)
    saturation_delay: float = 1.0    # budgets enforced above this est. delay
    # --- adaptive refill (ROADMAP gap: derive capacity from measurement) ---
    # When set, the bucket refill rate tracks the *measured* fleet
    # throughput (HealthMonitor token-rate EWMA, via ``set_measured_rate``)
    # instead of the fixed configured capacity; ``token_budget_per_s`` then
    # only seeds the buckets until the first measurement lands.
    adaptive_refill: bool = False
    refill_headroom: float = 1.0     # measured rate × headroom = budget rate
    # --- decode-burn shed (prediction plane) ---
    # When the fleet's *predicted* inter-token delay (worst decode-capable
    # replica, from predicted remaining work — see
    # ``ClusterSimulator._predicted_tbt``) exceeds
    # ``tbt_shed_factor × tbt_budget``, sheddable classes are shed/deferred
    # directly, instead of waiting for the decode burn to surface in
    # queue-delay estimates.  0 disables (default: off, bit-identical).
    tbt_budget: float = 0.0          # seconds of acceptable TBT
    tbt_shed_factor: float = 1.0
    # --- per-replica budget shares (ROADMAP gap) ---
    # Split every class's refill across replicas proportional to their
    # measured ``tokens_out`` EWMAs (``set_replica_rates``, fed by the
    # HealthMonitor): a class's traffic can then not pile onto one replica
    # past that replica's demonstrated capacity even while the fleet-total
    # budget still has headroom.  Enforced only when the caller passes the
    # routed replica to ``admit`` (the cluster simulator does).
    per_replica_shares: bool = False


@dataclass
class AdmissionDecision:
    """Outcome of one ``admit`` call (reason: ok/shed/defer/budget)."""
    admitted: bool
    slo: SLOClass
    reason: str = "ok"
    est_delay: float = 0.0


@dataclass
class _RetryEntry:
    req: Request
    slo: SLOClass
    next_attempt: float
    first_reject: float


class AdmissionController:
    """Replica-facing admission: consulted by the cluster simulator on
    arrival (shed/defer) and by replicas at dispatch (deadline drop).  Also
    usable standalone by ``serving.engine`` via the same ``admit`` hook.

    Drive the re-admission queue by calling ``due_retries(now)`` and
    re-offering each returned request to ``admit(...,
    retry=True)`` — the cluster simulator and serving engine both do."""

    def __init__(self, classes=DEFAULT_SLO_CLASSES,
                 classify: Optional[Callable[[Request], str]] = None,
                 shed_factor: float = 1.0,
                 config: Optional[AdmissionConfig] = None):
        self.classes = {c.name: c for c in classes}
        self._classify = classify or classify_by_length
        # Observability handle (obs.Observability), wired by the cluster
        # simulator / serving engine.  None ⇒ zero-cost, decisions unchanged.
        self.obs = None
        # No config → v1 semantics (one-shot shed, no retries/budgets); an
        # explicit AdmissionConfig wins over the legacy shed_factor arg.
        self.cfg = config or AdmissionConfig(shed_factor=shed_factor,
                                             retry_capacity=0)
        self.shed_factor = self.cfg.shed_factor     # legacy attribute
        names = [c.name for c in classes]
        self.shed: dict[str, int] = {n: 0 for n in names}
        self.admitted: dict[str, int] = {n: 0 for n in names}
        self.dropped: dict[str, int] = {n: 0 for n in names}
        self.deferred: dict[str, int] = {n: 0 for n in names}
        self.readmitted: dict[str, int] = {n: 0 for n in names}
        self.budget_denied: dict[str, int] = {n: 0 for n in names}
        self.tbt_denied: dict[str, int] = {n: 0 for n in names}
        # Decode-pressure oracle (prediction plane), wired by the cluster
        # simulator: () -> predicted fleet TBT in seconds, or None when no
        # predictor / no prediction stamps exist (the check then no-ops, so
        # predictor-off is bit-identical).
        self.decode_pressure_fn: Optional[Callable[[], Optional[float]]] = None
        # re-admission queue (bounded) + ids currently/ever deferred
        self._retry_q: deque[_RetryEntry] = deque()
        self._deferred_ids: set[int] = set()
        # per-class token buckets (weighted fair share of the budget rate —
        # the configured capacity, or the measured fleet throughput once
        # adaptive_refill observes one)
        self._total_w = sum(c.weight for c in classes) or 1.0
        self._budget_rate = self.cfg.token_budget_per_s
        self._rates = {c.name: self._budget_rate * c.weight / self._total_w
                       for c in classes}
        self._buckets = {n: self._rates[n] * self.cfg.budget_window
                         for n in names}
        self._bucket_t = 0.0
        # per-replica shares: replica_id -> fraction of the fleet refill,
        # and (class, replica) sub-buckets carved from each class's rate
        self._rep_share: dict[int, float] = {}
        self._rep_rates: dict[tuple[str, int], float] = {}
        self._rep_buckets: dict[tuple[str, int], float] = {}
        self.replica_denied: dict[int, int] = {}

    def wants_replica_hint(self) -> bool:
        """Whether ``admit`` benefits from knowing the routed replica."""
        return self.cfg.per_replica_shares

    def set_replica_rates(self, rates: dict[int, float]) -> None:
        """Per-replica budget shares: split every class's refill across
        replicas proportional to their measured rate EWMAs.  The caller
        decides who participates and with which signal — the cluster
        simulator passes *prefill-capable* replicas only (admission hints
        always name one), rated by output-token EWMA for unified replicas
        and prefill-token EWMA for prefill-role ones, so a disaggregated
        pool's shares track demonstrated prefill capacity instead of
        handing budget to decode replicas whose buckets no admission check
        reads (``ClusterSimulator._admission_share_rates``).  Replicas that
        disappeared drop their sub-buckets; new ones start at their share's
        burst cap."""
        if not self.cfg.per_replica_shares:
            return
        positive = [r for r in rates.values() if r > 0]
        if not positive:
            return
        # A replica with no measured output yet (fresh scale-up — added
        # precisely because of a burst) gets the mean measured rate as its
        # provisional share: a zero share would starve the new capacity of
        # exactly the traffic it was added for.
        floor = sum(positive) / len(positive)
        shares = {rid: (r if r > 0 else floor) for rid, r in rates.items()}
        total = sum(shares.values())
        self._rep_share = {rid: r / total for rid, r in shares.items()}
        live_keys = set()
        for name, class_rate in self._rates.items():
            for rid, share in self._rep_share.items():
                key = (name, rid)
                live_keys.add(key)
                rate = class_rate * share
                self._rep_rates[key] = rate
                cap = rate * self.cfg.budget_window
                if key in self._rep_buckets:
                    self._rep_buckets[key] = min(self._rep_buckets[key], cap)
                else:
                    self._rep_buckets[key] = cap
        for key in list(self._rep_rates):
            if key not in live_keys:
                self._rep_rates.pop(key, None)
                self._rep_buckets.pop(key, None)

    def set_measured_rate(self, tokens_per_s: float) -> None:
        """Adaptive refill: retarget the per-class bucket rates at the
        measured fleet throughput (× headroom).  No-op unless
        ``adaptive_refill`` is set and the measurement is positive; existing
        bucket levels are clipped to the new burst caps so a rate *drop*
        takes effect immediately."""
        if not self.cfg.adaptive_refill or tokens_per_s <= 0:
            return
        self._budget_rate = tokens_per_s * self.cfg.refill_headroom
        for name in self._rates:
            w = self.classes[name].weight
            self._rates[name] = self._budget_rate * w / self._total_w
            cap = self._rates[name] * self.cfg.budget_window
            self._buckets[name] = min(self._buckets[name], cap)
        if self._rep_share:
            # keep the per-replica split in step with the retargeted rates
            self.set_replica_rates(self._rep_share)

    def slo_of(self, req: Request) -> SLOClass:
        """The SLO class this request is admitted (and budgeted) under."""
        return self.classes[self._classify(req)]

    # ---- per-class token budgets -----------------------------------------

    @staticmethod
    def _token_cost(req: Request) -> float:
        # Effective length (KV plane): a cached prefix costs no prefill
        # budget.  Output side is the *predicted* token count when a
        # prediction is stamped (prediction plane) — a request predicted to
        # decode 1k tokens charges its class budget accordingly instead of
        # hiding behind max_new_tokens defaults.  Identical to
        # prompt_len + max_new_tokens when neither plane stamped it.
        out = (req.predicted_output if req.predicted_output is not None
               else float(req.max_new_tokens))
        return float(req.effective_len + out)

    def _refill(self, now: float) -> None:
        dt = now - self._bucket_t
        if dt <= 0:
            return
        self._bucket_t = now
        for name, rate in self._rates.items():
            cap = rate * self.cfg.budget_window
            self._buckets[name] = min(cap, self._buckets[name] + rate * dt)
        for key, rate in self._rep_rates.items():
            cap = rate * self.cfg.budget_window
            self._rep_buckets[key] = min(cap,
                                         self._rep_buckets[key] + rate * dt)

    def budget_remaining(self, class_name: str) -> float:
        """Current token-bucket level for a class (0.0 when budgets are off)."""
        return self._buckets.get(class_name, 0.0)

    # ---- arrival / retry path --------------------------------------------

    def admit(self, req: Request, now: float, est_delay: float,
              retry: bool = False,
              replica_id: Optional[int] = None) -> AdmissionDecision:
        """Arrival-time (or retry-time) decision given the cluster's
        best-case queue delay estimate (the router's min route cost).
        ``replica_id`` is the router's tentative placement — with
        ``per_replica_shares`` it is additionally held to that replica's
        slice of the class budget."""
        slo = self.slo_of(req)
        budgets_on = self._budget_rate > 0
        if budgets_on:
            self._refill(now)
        # 1) Weighted fair share under saturation: a class that exhausted
        #    its token bucket — or its share of the *routed replica's*
        #    bucket — is refused even if its own TTFT still fits.
        if (budgets_on and slo.sheddable
                and est_delay > self.cfg.saturation_delay):
            cost = self._token_cost(req)
            rep_key = ((slo.name, replica_id) if replica_id is not None
                       else None)
            if self._buckets[slo.name] < cost:
                self.budget_denied[slo.name] += 1
                return self._reject(req, slo, now, est_delay, "budget")
            if (rep_key is not None and rep_key in self._rep_buckets
                    and self._rep_buckets[rep_key] < cost):
                self.budget_denied[slo.name] += 1
                self.replica_denied[replica_id] = \
                    self.replica_denied.get(replica_id, 0) + 1
                return self._reject(req, slo, now, est_delay, "budget")
        # 1b) Decode-burn shed (prediction plane): when the fleet's
        #     *predicted* TBT already burns the budget, refuse sheddable
        #     work now — admitting it would join a decode pool predicted to
        #     stall, which queue-delay estimates only discover later.
        if (slo.sheddable and self.cfg.tbt_budget > 0
                and self.decode_pressure_fn is not None):
            tbt = self.decode_pressure_fn()
            if (tbt is not None
                    and tbt > self.cfg.tbt_shed_factor * self.cfg.tbt_budget):
                self.tbt_denied[slo.name] += 1
                return self._reject(req, slo, now, est_delay, "decode_burn")
        # 2) SLO feasibility shed.
        if slo.sheddable and est_delay > self.cfg.shed_factor * slo.ttft_target:
            return self._reject(req, slo, now, est_delay, "shed")
        # Admitted: charge the budget and count the request exactly once.
        if budgets_on and slo.sheddable:
            cost = self._token_cost(req)
            self._buckets[slo.name] = max(0.0, self._buckets[slo.name] - cost)
            rep_key = ((slo.name, replica_id) if replica_id is not None
                       else None)
            if rep_key is not None and rep_key in self._rep_buckets:
                self._rep_buckets[rep_key] = max(
                    0.0, self._rep_buckets[rep_key] - cost)
        self.admitted[slo.name] += 1
        if retry and req.request_id in self._deferred_ids:
            self.readmitted[slo.name] += 1
        self._deferred_ids.discard(req.request_id)
        if self.obs is not None:
            self.obs.inc("admission_decisions_total",
                         {"decision": "admit", "slo_class": slo.name})
            self.obs.event("admit", now, request_id=req.request_id,
                           data={"slo_class": slo.name,
                                 "est_delay": round(est_delay, 6)})
        return AdmissionDecision(True, slo, reason="ok", est_delay=est_delay)

    def _retry_limit(self, slo: SLOClass) -> float:
        return slo.deadline if slo.deadline is not None else self.cfg.retry_ttl

    def _reject(self, req: Request, slo: SLOClass, now: float,
                est_delay: float, why: str) -> AdmissionDecision:
        """Defer into the bounded re-admission queue when the request can
        still make its deadline; permanent shed otherwise."""
        age_next = (now + self.cfg.retry_backoff) - req.arrival_time
        if (self.cfg.retry_capacity > 0
                and len(self._retry_q) < self.cfg.retry_capacity
                and age_next < self._retry_limit(slo)):
            self.deferred[slo.name] += 1
            self._deferred_ids.add(req.request_id)
            self._retry_q.append(_RetryEntry(
                req=req, slo=slo, next_attempt=now + self.cfg.retry_backoff,
                first_reject=now))
            if self.obs is not None:
                self.obs.inc("admission_decisions_total",
                             {"decision": "defer", "slo_class": slo.name})
                self.obs.event("defer", now, request_id=req.request_id,
                               data={"slo_class": slo.name, "why": why,
                                     "est_delay": round(est_delay, 6)})
            return AdmissionDecision(False, slo, reason="defer",
                                     est_delay=est_delay)
        self.shed[slo.name] += 1
        self._deferred_ids.discard(req.request_id)
        # The one terminal stamp for admission-rejected work: every caller
        # (cluster simulator, serving engine) treats a non-defer rejection
        # as a permanent shed.
        req.terminal = TerminalState.SHED
        if self.obs is not None:
            decision = {"budget": "budget_deny",
                        "decode_burn": "decode_burn_deny"}.get(why, "shed")
            self.obs.inc("admission_decisions_total",
                         {"decision": decision, "slo_class": slo.name})
            self.obs.inc("requests_terminal_total",
                         {"state": TerminalState.SHED.value,
                          "slo_class": slo.name})
            self.obs.event("shed", now, request_id=req.request_id,
                           data={"slo_class": slo.name, "why": why,
                                 "est_delay": round(est_delay, 6)})
        return AdmissionDecision(False, slo, reason=why, est_delay=est_delay)

    # ---- re-admission queue ----------------------------------------------

    def park(self, req: Request, now: float) -> bool:
        """Park an orphaned in-flight request (engine failure / heartbeat
        lapse) directly into the bounded re-admission queue — the fleet's
        recovery path rides the same defer/retry pump as admission-time
        deferrals.  Returns False (permanent shed, terminal stamped) when
        the queue is full or the deadline cannot be made."""
        slo = self.slo_of(req)
        dec = self._reject(req, slo, now, 0.0, "orphaned")
        return dec.reason == "defer"

    def retry_pending(self) -> int:
        """Number of deferred requests parked in the re-admission queue."""
        return len(self._retry_q)

    def next_retry_time(self) -> Optional[float]:
        """Earliest backoff expiry in the retry queue (None when empty)."""
        if not self._retry_q:
            return None
        return min(e.next_attempt for e in self._retry_q)

    def due_retries(self, now: float
                    ) -> tuple[list[Request], list[Request]]:
        """Pop every parked request whose backoff elapsed.  Returns
        ``(due, expired)``: the caller re-offers ``due`` through
        ``admit(..., retry=True)``; ``expired`` aged past their deadline in
        the queue and are permanently shed (already counted here)."""
        due: list[Request] = []
        expired: list[Request] = []
        keep: deque[_RetryEntry] = deque()
        for e in self._retry_q:
            if e.next_attempt > now:
                keep.append(e)
            elif now - e.req.arrival_time >= self._retry_limit(e.slo):
                self.shed[e.slo.name] += 1
                self._deferred_ids.discard(e.req.request_id)
                e.req.state = RequestState.FAILED
                e.req.finish_time = now
                e.req.terminal = TerminalState.SHED
                if self.obs is not None:
                    self.obs.inc("requests_terminal_total",
                                 {"state": TerminalState.SHED.value,
                                  "slo_class": e.slo.name})
                    self.obs.event("shed", now,
                                   request_id=e.req.request_id,
                                   data={"slo_class": e.slo.name,
                                         "why": "retry_expired"})
                expired.append(e.req)
            else:
                due.append(e.req)
        self._retry_q = keep
        return due, expired

    # ---- dispatch-time deadline drop -------------------------------------

    def expired(self, req: Request, now: float) -> bool:
        """Dispatch-time deadline drop: the request aged out while queued."""
        slo = self.slo_of(req)
        if slo.deadline is not None and req.wait_time(now) > slo.deadline:
            self.dropped[slo.name] += 1
            return True
        return False

    def stats(self) -> dict:
        """Counter snapshot (admitted/shed/dropped/deferred/... per class)."""
        return {"admitted": dict(self.admitted), "shed": dict(self.shed),
                "dropped": dict(self.dropped),
                "deferred": dict(self.deferred),
                "readmitted": dict(self.readmitted),
                "budget_denied": dict(self.budget_denied),
                "tbt_denied": dict(self.tbt_denied),
                "budget_rate": self._budget_rate,
                "replica_shares": dict(self._rep_share),
                "replica_denied": dict(self.replica_denied),
                "retry_pending": len(self._retry_q)}
