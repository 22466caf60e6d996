"""Cluster-level discrete-event simulator.

Drives N ``ReplicaModel``s (each with its own scheduler + cost-model
executor, see replica.py) under a ``Router`` policy, optional SLO
``AdmissionController``, disaggregated prefill/decode handoffs, and a
scripted scenario (failures, scale-up, speed changes) — all on CPU using
the same step-cost machinery as ``core/simulator.py``, so every number is
comparable "simulator units".

Event loop per iteration:

  arrivals → (admission shed?) → router → replica.submit
  health check → failures re-enqueued, stragglers drained+re-routed
  handoff movement (prefill outbox → channel → decode inbox)
  evictions from decode replicas re-routed (recompute needs a prefill pool)
  ready replicas step (one engine tick each, advancing their busy_until)
  global clock jumps to the next event
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.cost_model import CostModel
from ..core.scheduler import BaseScheduler, FCFSScheduler
from ..core.types import Request, RequestState, TerminalState
from ..kvplane.directory import PrefixDirectory
from ..kvplane.topology import LinkTopology
from .admission import AdmissionController, classify_by_length
from .autoscaler import SLOBurnAutoscaler
from .disagg import HandoffChannel
from .health import HealthConfig, HealthMonitor
from .policy_store import PolicyStore
from .replica import ReplicaModel, ReplicaParams
from .router import EWSJFRouter, Router


@dataclass
class ScenarioEvent:
    """Scripted control-plane event: ``action`` in {fail, drain, add_replica,
    set_speed}.  Intended for *fault injection* (failures, stragglers,
    speed changes); steady-state elasticity should come from the reactive
    ``SLOBurnAutoscaler`` rather than scripted ``add_replica`` events."""

    time: float
    action: str
    replica_id: int = -1
    speed: float = 1.0
    role: str = "unified"
    scheduler_factory: Optional[Callable[[], BaseScheduler]] = None


@dataclass
class ClusterSimResult:
    """Everything a cluster run produced: per-request outcomes, per-plane
    stats, and the derived TTFT/throughput/capacity metrics."""
    total_time: float
    finished: list[Request]
    shed: list[Request]
    dropped: list[Request]
    reenqueued: int
    handoff_stats: dict
    replica_stats: list[dict]
    health: dict
    admission: dict = field(default_factory=dict)
    autoscale: dict = field(default_factory=dict)
    policy: dict = field(default_factory=dict)
    prefix: dict = field(default_factory=dict)   # KV plane (directory+caches)
    readmitted: int = 0
    # Unified terminal accounting (TerminalState.value -> count) — the one
    # outcome classification all planes agree on, derived from the
    # ``Request.terminal`` stamps rather than per-component counters.
    terminal: dict = field(default_factory=dict)
    # Per-SLO-class latency percentiles (obs.slo.slo_report shape), filled
    # when the run had a metrics registry; see ``slo_report()`` for the
    # registry-free fallback.
    slo: dict = field(default_factory=dict)

    @property
    def req_per_s(self) -> float:
        """Finished requests per simulated second."""
        return len(self.finished) / max(self.total_time, 1e-9)

    @property
    def tok_per_s(self) -> float:
        """Generated tokens per simulated second (the equal-throughput guard)."""
        toks = sum(r.generated for r in self.finished)
        return toks / max(self.total_time, 1e-9)

    @property
    def replica_seconds(self) -> float:
        """Total capacity consumed: Σ per-replica (death − birth), with the
        run end standing in for still-alive replicas.  The denominator of
        the role-aware autoscaling claim (same SLO recovery, less
        capacity)."""
        return sum(s.get("replica_seconds", 0.0) for s in self.replica_stats)

    def ttft_stats(self, short_threshold: int = 256) -> dict:
        """TTFT mean/percentiles over all finished requests, split
        short/long at ``short_threshold`` prompt tokens."""
        def s(a):
            if not len(a):
                return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
            return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
                    "p95": float(np.percentile(a, 95)),
                    "p99": float(np.percentile(a, 99))}
        ttfts = np.asarray([r.ttft for r in self.finished
                            if r.ttft is not None])
        short = np.asarray([r.ttft for r in self.finished
                            if r.ttft is not None
                            and r.prompt_len <= short_threshold])
        longs = np.asarray([r.ttft for r in self.finished
                            if r.ttft is not None
                            and r.prompt_len > short_threshold])
        return {"all": s(ttfts), "short": s(short), "long": s(longs)}

    def slo_report(self, classify=None) -> dict:
        """Per-class TTFT/TBT/E2E percentiles in the shared obs shape.
        Returns the live-registry report when the run recorded one;
        otherwise rebuilds it from the finished requests through the same
        histogram code path (identical bucketing and bounds)."""
        if self.slo:
            return self.slo
        from ..obs.slo import slo_or_fallback
        return slo_or_fallback(None, self.finished,
                               classify or classify_by_length)

    def ttft_by_class(self, classify=None) -> dict:
        """Per-SLO-class TTFT stats (mean/p95/n) over finished requests."""
        from .admission import classify_by_length
        classify = classify or classify_by_length
        groups: dict[str, list[float]] = {}
        for r in self.finished:
            if r.ttft is not None:
                groups.setdefault(classify(r), []).append(r.ttft)
        return {name: {"mean": float(np.mean(v)),
                       "p95": float(np.percentile(v, 95)), "n": len(v)}
                for name, v in groups.items()}


class ClusterSimulator:
    """Discrete-event loop over a replica fleet: admission, routing,
    health, handoffs, autoscaling, policy/prefix sync, engine ticks."""
    def __init__(self, replicas: Sequence[ReplicaModel], router: Router,
                 cost: CostModel,
                 admission: Optional[AdmissionController] = None,
                 channel: Optional[HandoffChannel] = None,
                 health: HealthConfig | None = None,
                 autoscaler: Optional[SLOBurnAutoscaler] = None,
                 policy_store: Optional[PolicyStore] = None,
                 topology: Optional[LinkTopology] = None,
                 prefix_directory: Optional[PrefixDirectory] = None,
                 obs=None, predictor=None):
        self.replicas: list[ReplicaModel] = list(replicas)
        self.router = router
        self.cost = cost
        self.admission = admission
        # Prediction plane (repro_torch.predict.LengthPredictor or None).  One
        # shared predictor is threaded through ingest (requests stamped
        # *before* admission and routing see them), every replica (victim
        # selection, decode costing, observe-at-finish), every scheduler
        # (policy-store posterior export), and admission's decode-pressure
        # oracle.  None — or a predictor that abstains — leaves every
        # decision bit-identical to the length-blind simulator.
        self.predictor = predictor
        if predictor is not None:
            for rep in self.replicas:
                rep.predictor = predictor
                rep.sched.predictor = predictor
            if admission is not None \
                    and admission.decode_pressure_fn is None:
                admission.decode_pressure_fn = self._predicted_tbt
        # Observability plane (obs.Observability or None).  One handle is
        # threaded through every instrumented component; with None every
        # emission site is a single attribute check and scheduling
        # decisions are bit-identical to the uninstrumented simulator
        # (equivalence-tested in tests/test_obs.py).
        self.obs = obs
        # per-SLO-class pre-bound arrival counter handles (hot ingest path)
        self._arrived_h: dict = {}
        if obs is not None:
            if admission is not None:
                # label SLO classes the way admission actually classifies
                obs.classify = admission._classify
                admission.obs = obs
            if isinstance(router, EWSJFRouter):
                router.obs = obs
            for rep in self.replicas:
                rep.obs = obs
        self.autoscaler = autoscaler
        self.policy_store = policy_store
        self.prefix_directory = prefix_directory
        # KV movement: per-link topology with compute overlap (handoffs
        # *and* remote prefix fetches share its link clocks).  An
        # explicitly passed legacy ``HandoffChannel`` still wins for
        # *handoffs* (serialized single-channel model, kept for comparison), but the
        # topology always exists — otherwise a wired prefix directory
        # would plan remote fetches that replicas can never execute.
        self.topology = topology or LinkTopology()
        self.channel = channel if channel is not None else self.topology
        for rep in self.replicas:
            rep.topology = self.topology
            rep.peer_alive_fn = self._peer_alive
        self.monitor = HealthMonitor(health)
        self.reenqueued = 0
        self.readmitted = 0
        self.shed: list[Request] = []
        self.backlog: list[Request] = []     # admitted but unroutable (yet)
        self.now = 0.0
        if admission is not None:
            for rep in self.replicas:
                rep.drop_fn = admission.expired
        # One strategic plane: hand the shared store to the router (global
        # partition map for routing) and the autoscaler (warm starts) unless
        # the caller wired their own.  Same for the KV plane: the router
        # reads the shared prefix directory + topology for effective-length
        # routing costs.
        if policy_store is not None:
            if isinstance(router, EWSJFRouter) and router.policy_store is None:
                router.policy_store = policy_store
            if autoscaler is not None and autoscaler.policy_store is None:
                autoscaler.policy_store = policy_store
        if isinstance(router, EWSJFRouter):
            if prefix_directory is not None and router.directory is None:
                router.directory = prefix_directory
            if self.topology is not None and router.topology is None:
                router.topology = self.topology

    # ---- membership -------------------------------------------------------

    def add_replica(self, scheduler: BaseScheduler, role: str = "unified",
                    speed: float = 1.0,
                    params: ReplicaParams | None = None) -> ReplicaModel:
        """Join a new replica (scale-up path, warm-started when a policy
        store is wired).  Stamps ``born`` for replica-seconds accounting."""
        rid = 1 + max((r.replica_id for r in self.replicas), default=-1)
        rep = ReplicaModel(rid, self.cost, scheduler=scheduler, params=params,
                           role=role, speed=speed)
        rep.born = self.now
        rep.last_heartbeat = self.now
        rep.topology = self.topology
        rep.peer_alive_fn = self._peer_alive
        rep.obs = self.obs
        if self.predictor is not None:
            rep.predictor = self.predictor
            scheduler.predictor = self.predictor
        if self.admission is not None:
            rep.drop_fn = self.admission.expired
        # Warm start: a new replica inherits the fleet's learned policy
        # instead of relearning from a single [0, ∞) queue (the single
        # ``PolicyStore.warm_start`` path — autoscaler scale-ups and
        # scripted add_replica events both land here).
        if self.policy_store is not None:
            self.policy_store.warm_start(scheduler, now=self.now)
        self.replicas.append(rep)
        return rep

    def replica(self, replica_id: int) -> ReplicaModel:
        """Lookup by replica id (raises StopIteration if absent)."""
        return next(r for r in self.replicas if r.replica_id == replica_id)

    # ---- ingestion --------------------------------------------------------

    def _est_best_delay(self, req: Request) -> float:
        """Best-case start delay across the cluster (for admission)."""
        pool = [r for r in self.replicas if r.accepts_prefill()]
        if not pool:
            return float("inf")
        if isinstance(self.router, EWSJFRouter):
            return min(self.router.route_cost(r, req, self.now) for r in pool)
        return min(r.exec_residual(self.now) + r.backlog_cost(self.now)
                   for r in pool)

    def ingest(self, req: Request) -> bool:
        """Admission + routing for one arrival.  Returns False if not (yet)
        admitted — deferred requests park in the controller's re-admission
        queue and are re-offered by ``_pump_retries``."""
        if self.predictor is not None:
            # Stamp predicted_output / predicted_extra before admission or
            # routing read the request: admission charges predicted tokens,
            # the router looks up queues in work-length space, and the
            # scheduler queues by work_len.  Runs before the router's
            # prefix annotation, so the stamp is decode-side-only and
            # composes with the later cached_len discount.
            self.predictor.annotate(req, self.now)
        if self.obs is not None:
            if self.obs.trace is not None:
                self.obs.trace.emit("arrival", self.now, req.request_id)
            if self.obs.metrics is not None:
                cls = self.obs.slo_class(req)
                h = self._arrived_h.get(cls)
                if h is None:
                    h = self._arrived_h[cls] = self.obs.metrics.counter(
                        "requests_arrived_total", {"slo_class": cls})
                h.inc()
        if self.admission is not None:
            rep, rid = self._replica_hint(req)
            est = (self.router.route_cost(rep, req, self.now)
                   if rid is not None and isinstance(self.router, EWSJFRouter)
                   else self._est_best_delay(req))
            dec = self.admission.admit(req, self.now, est, replica_id=rid)
            if not dec.admitted:
                if dec.reason != "defer":
                    req.state = RequestState.FAILED
                    req.finish_time = self.now
                    self.shed.append(req)
                return False
            if rid is not None:
                rep.submit(req, self.now)      # already routed for the hint
                return True
        self._route(req)
        return True

    def _predicted_tbt(self) -> Optional[float]:
        """Predicted fleet inter-token delay: the worst decode-capable
        replica's step time at its *mid-drain* predicted KV footprint
        (current KV plus half the predicted remaining tokens), at that
        replica's speed.  The admission controller's decode-pressure
        oracle.  Returns None — the decode-burn check no-ops — when no
        decode batch carries a prediction stamp."""
        worst: Optional[float] = None
        for r in self.replicas:
            if not r.accepts_decode():
                continue
            tbt = r.predicted_step_seconds()
            if tbt is not None and (worst is None or tbt > worst):
                worst = tbt
        return worst

    def _peer_alive(self, replica_id: int) -> bool:
        """Liveness oracle for replicas' remote-prefix fetches: a fetch plan
        stamped before its source failed must not execute."""
        return any(r.replica_id == replica_id and r.alive
                   for r in self.replicas)

    def _replica_hint(self, req: Request
                      ) -> tuple[Optional[ReplicaModel], Optional[int]]:
        """Tentative routing decision for per-replica admission budget
        shares.  Only taken when the controller wants it, so the default
        admission path keeps its historical select-after-admit order."""
        if not self.admission.wants_replica_hint():
            return None, None
        rep = self.router.select(self.replicas, req, self.now)
        return rep, (rep.replica_id if rep is not None else None)

    def _pump_retries(self, now: float) -> None:
        """Re-offer parked requests whose backoff elapsed; expired ones are
        permanently shed."""
        due, expired = self.admission.due_retries(now)
        self.shed.extend(expired)
        for req in due:
            rep, rid = self._replica_hint(req)
            est = (self.router.route_cost(rep, req, now)
                   if rid is not None and isinstance(self.router, EWSJFRouter)
                   else self._est_best_delay(req))
            dec = self.admission.admit(req, now, est, retry=True,
                                       replica_id=rid)
            if dec.admitted:
                self.readmitted += 1
                if rid is not None:
                    rep.submit(req, now)
                else:
                    self._route(req)
            elif dec.reason != "defer":
                req.state = RequestState.FAILED
                req.finish_time = now
                self.shed.append(req)

    def _route(self, req: Request) -> None:
        rep = self.router.select(self.replicas, req, self.now)
        if rep is None:
            self.backlog.append(req)
        else:
            rep.submit(req, self.now)

    # ---- control-plane reactions ------------------------------------------

    def _handle_failure(self, rep: ReplicaModel) -> None:
        if self.obs is not None:
            # flight-recorder dump: freeze the lifecycle ring at the
            # moment of failure for post-mortem reconstruction
            self.obs.dump(f"replica_{rep.replica_id}_failure", self.now)
            self.obs.event("replica_fail", self.now,
                           replica_id=rep.replica_id)
            self.obs.inc("replica_failures_total")
        if self.policy_store is not None:
            self.policy_store.forget(rep.replica_id)
        if self.prefix_directory is not None:
            self.prefix_directory.forget(rep.replica_id)
        if rep.died is None:
            rep.died = self.now
        for req in rep.fail():
            self.reenqueued += 1
            self._route(req)

    def _handle_drain(self, rep: ReplicaModel) -> None:
        if self.obs is not None:
            # drains fire on straggler detection (and scale-down) — dump
            # the ring so the slow replica's backlog is reconstructable
            self.obs.dump(f"replica_{rep.replica_id}_drain", self.now)
            self.obs.event("replica_drain", self.now,
                           replica_id=rep.replica_id)
            self.obs.inc("replica_drains_total")
        if self.policy_store is not None:
            self.policy_store.forget(rep.replica_id)
        if self.prefix_directory is not None:
            self.prefix_directory.forget(rep.replica_id)
        for req in rep.start_drain():
            self._route(req)
        if not rep.alive and rep.died is None:
            rep.died = self.now      # idle drain completes immediately

    def _prefix_sync(self, now: float) -> None:
        """One KV-plane directory round: every live caching replica
        advertises its hot prefixes, then the store merges to a new (or
        unchanged) epoch — the same publish→merge cadence pattern as the
        policy store, and equally non-blocking."""
        for rep in self.replicas:
            if rep.alive and rep.radix is not None:
                self.prefix_directory.publish(rep.replica_id,
                                              rep.prefix_adverts(), now)
        self.prefix_directory.merge(now)

    def _policy_sync(self, now: float) -> None:
        """One strategic-plane round: publish → merge → broadcast (the
        shared ``PolicyStore.sync_fleet`` protocol).  Replicas whose
        scheduler has no strategic loop (FCFS/SJF) are skipped; a replica
        that already adopted the current epoch is left alone
        (staleness-versioned epochs make the broadcast idempotent and
        non-blocking)."""
        self.policy_store.sync_fleet(
            ((rep.replica_id, rep.sched, self._class_delays(rep))
             for rep in self.replicas if rep.schedulable()), now)
        if self.obs is not None:
            st = self.policy_store.stats()
            self.obs.gauge("policy_epoch", v=float(st.get("epoch", 0)))
            self.obs.gauge("policy_stale_dropped",
                           v=float(st.get("stale_dropped", 0)))
            self.obs.gauge("policy_merges", v=float(st.get("merges", 0)))

    @staticmethod
    def _class_delays(rep: ReplicaModel, tail: int = 200) -> dict:
        """Per-SLO-class mean TTFT over the replica's recent finishes
        (strategic telemetry for the store; read-only)."""
        acc: dict[str, tuple[float, int]] = {}
        for r in rep.finished[-tail:]:
            if r.ttft is None:
                continue
            name = classify_by_length(r)
            m, n = acc.get(name, (0.0, 0))
            acc[name] = ((m * n + r.ttft) / (n + 1), n + 1)
        return acc

    def _autoscale_tick(self, now: float) -> None:
        """One reactive-control round: fold the health monitor's queue-delay
        samples into per-class burn (and, role-aware, its decode-pressure
        samples into decode burn), then apply the scale decisions — one per
        pool in role-aware mode, at most one total otherwise.  The delay
        samples are *drained* from the replicas' dispatch logs here, so a
        policy-sync round sharing this event-loop iteration can never feed
        the same observation into burn twice."""
        self.autoscaler.ingest(self.monitor.delay_samples(self.replicas, now))
        if self.autoscaler.role_aware:
            self.autoscaler.ingest_decode(
                self.monitor.decode_samples(self.replicas))
            self._obs_burn(now)
            for act, pool in self.autoscaler.decide_roles(self.replicas, now):
                if act == "up":
                    rep = self.add_replica(self.autoscaler.make_scheduler(now),
                                           role=pool.role, speed=pool.speed)
                    self.autoscaler.note_scaled("up", rep, now,
                                                role=pool.role)
                else:
                    victim = self.autoscaler.drain_candidate(self.replicas,
                                                             pool=pool)
                    if victim is not None:
                        self._handle_drain(victim)
                        self.autoscaler.note_scaled("down", victim, now,
                                                    role=pool.role)
                if self.obs is not None:
                    self.obs.inc("autoscaler_actions_total",
                                 {"action": act, "role": pool.role})
            return
        self._obs_burn(now)
        act = self.autoscaler.decide(self.replicas, now)
        if act == "up":
            rep = self.add_replica(self.autoscaler.make_scheduler(now),
                                   role=self.autoscaler.cfg.role,
                                   speed=self.autoscaler.cfg.speed)
            self.autoscaler.note_scaled("up", rep, now)
        elif act == "down":
            victim = self.autoscaler.drain_candidate(self.replicas)
            if victim is not None:
                self._handle_drain(victim)
                self.autoscaler.note_scaled("down", victim, now)
        if act in ("up", "down") and self.obs is not None:
            self.obs.inc("autoscaler_actions_total",
                         {"action": act, "role": self.autoscaler.cfg.role})

    def _obs_burn(self, now: float) -> None:
        """Record the autoscaler's burn signals as gauges + timelines."""
        if self.obs is None:
            return
        for cls, b in self.autoscaler.burn.items():
            self.obs.gauge("autoscaler_burn", {"class": cls}, b)
            self.obs.timeline("autoscaler_burn", now, b, {"class": cls})
        db = self.autoscaler.decode_burn
        self.obs.gauge("autoscaler_burn", {"class": "decode"}, db)
        self.obs.timeline("autoscaler_burn", now, db, {"class": "decode"})

    def _admission_share_rates(self) -> dict[int, float]:
        """Per-replica rate signal for the admission budget-share split,
        restricted to routing targets.  Admission hints always name a
        *prefill-capable* replica, so in a disaggregated fleet the shares
        must be split across the prefill pool only — splitting across all
        replicas hands most of the budget to decode replicas (they own the
        ``tokens_out`` mass) whose buckets no admission check ever reads,
        throttling the prefill pool to a fraction of the fleet budget and
        starving freshly scaled decode capacity of the very traffic it was
        added for.  Prefill-role replicas are rated by their prefill-token
        EWMA (their output-token rate is ~0: handoffs finish downstream);
        unified replicas keep the historical output-token EWMA."""
        rates: dict[int, float] = {}
        for r in self.replicas:
            if not r.accepts_prefill():
                continue
            if r.role == "prefill":
                rates[r.replica_id] = self.monitor.replica_prefill_rate.get(
                    r.replica_id, 0.0)
            else:
                rates[r.replica_id] = self.monitor.replica_rate.get(
                    r.replica_id, 0.0)
        return rates

    def _apply_event(self, ev: ScenarioEvent) -> None:
        if ev.action == "fail":
            self._handle_failure(self.replica(ev.replica_id))
        elif ev.action == "drain":
            self._handle_drain(self.replica(ev.replica_id))
        elif ev.action == "set_speed":
            self.replica(ev.replica_id).speed = ev.speed
        elif ev.action == "add_replica":
            factory = ev.scheduler_factory or FCFSScheduler
            self.add_replica(factory(), role=ev.role, speed=ev.speed)
        else:
            raise ValueError(f"unknown scenario action {ev.action!r}")

    def _move_handoffs(self) -> None:
        decode_capable = any(r.accepts_decode() for r in self.replicas)
        for rep in self.replicas:
            # With no decode-capable replica anywhere, re-routing a handoff
            # would just re-prefill it forever; park it in the outbox until
            # one joins (e.g. scale-up) — the KV is already computed.
            while rep.outbox and decode_capable:
                h = rep.outbox.pop(0)
                dst = self.router.select_decode(self.replicas, h, self.now)
                self.channel.send(h, self.now, dst.replica_id)
                dst.accept_handoff(h, self.now)
                if self.obs is not None:
                    link = f"{h.src_replica}->{dst.replica_id}"
                    self.obs.event("handoff", self.now,
                                   request_id=h.req.request_id,
                                   replica_id=dst.replica_id,
                                   data={"src": h.src_replica,
                                         "bytes": int(h.kv_bytes)})
                    self.obs.inc("kv_handoff_bytes_total", {"link": link},
                                 float(h.kv_bytes))
            while rep.evicted:
                self._route(rep.evicted.pop(0))

    # ---- main loop ---------------------------------------------------------

    def run(self, requests: list[Request],
            scenario: Sequence[ScenarioEvent] = (),
            max_sim_time: float = 1e7) -> ClusterSimResult:
        """Drive ``requests`` (+ scripted fault events) to completion;
        returns the aggregated :class:`ClusterSimResult`."""
        arrivals = sorted(requests, key=lambda r: r.arrival_time)
        events = sorted(scenario, key=lambda e: e.time)
        ai = ei = 0
        n_total = len(arrivals)
        t = self.now

        def accounted() -> int:
            fin = sum(len(r.finished) for r in self.replicas)
            drp = sum(len(r.dropped) for r in self.replicas)
            return fin + drp + len(self.shed)

        guard = 0
        while accounted() < n_total and t < max_sim_time:
            guard += 1
            if guard > 50 * n_total + 10_000:
                break                                  # safety valve
            self.now = t
            while ei < len(events) and events[ei].time <= t:
                self._apply_event(events[ei])
                ei += 1
            while ai < n_total and arrivals[ai].arrival_time <= t:
                self.ingest(arrivals[ai])
                ai += 1
            if self.admission is not None and self.admission.retry_pending():
                self._pump_retries(t)
            if self.autoscaler is not None and self.autoscaler.due(t):
                self._autoscale_tick(t)
            if self.policy_store is not None and self.policy_store.due(t):
                self._policy_sync(t)
            if self.prefix_directory is not None \
                    and self.prefix_directory.due(t):
                self._prefix_sync(t)
            if self.backlog:
                still = []
                for req in self.backlog:
                    rep = self.router.select(self.replicas, req, t)
                    if rep is None:
                        still.append(req)
                    else:
                        rep.submit(req, t)
                self.backlog = still
            if self.monitor.due(t):
                rate = self.monitor.observe_throughput(self.replicas, t)
                self.monitor.observe_kv(self.replicas)
                if self.admission is not None:
                    # adaptive refill: budget rate follows measured fleet
                    # throughput (no-op unless AdmissionConfig enables it);
                    # per-replica shares follow the per-replica EWMAs.
                    self.admission.set_measured_rate(rate)
                    self.admission.set_replica_rates(
                        self._admission_share_rates())
                dead, drain = self.monitor.check(self.replicas, t)
                for rep in dead:
                    self._handle_failure(rep)
                for rep in drain:
                    self._handle_drain(rep)
            self._move_handoffs()

            stepped = False
            for rep in self.replicas:
                if rep.alive and rep.busy_until <= t and rep.has_work():
                    dt = rep.step(t)
                    rep.busy_until = t + dt
                    stepped = True
            self._move_handoffs()

            # advance the clock to the next event
            nxt = []
            if ai < n_total:
                nxt.append(arrivals[ai].arrival_time)
            if ei < len(events):
                nxt.append(events[ei].time)
            nxt.extend(rep.busy_until for rep in self.replicas
                       if rep.alive and rep.busy_until > t
                       and (rep.has_work() or rep.inflight()))
            pending_inbox = any(h.ready_time > t for rep in self.replicas
                                for h in rep.inbox)
            if pending_inbox:
                nxt.append(min(h.ready_time for rep in self.replicas
                               for h in rep.inbox if h.ready_time > t))
            if self.monitor.due(t) or self.backlog:
                nxt.append(t + self.monitor.cfg.check_interval)
            if self.admission is not None:
                nr = self.admission.next_retry_time()
                if nr is not None:
                    nxt.append(max(nr, t + 1e-9))
            if self.autoscaler is not None and self._in_system():
                nxt.append(t + self.autoscaler.cfg.check_interval)
            if self.policy_store is not None and self._in_system():
                nxt.append(t + self.policy_store.cfg.sync_interval)
            if self.prefix_directory is not None and self._in_system():
                nxt.append(t + self.prefix_directory.cfg.sync_interval)
            if nxt:
                t = max(t + 1e-9, min(nxt))
            elif not stepped:
                if ai >= n_total and self._in_system() == 0:
                    break        # defensive: nothing left anywhere
                t += self.monitor.cfg.check_interval
        self.now = t

        finished = [r for rep in self.replicas for r in rep.finished]
        dropped = [r for rep in self.replicas for r in rep.dropped]
        # Unified terminal accounting from the per-request stamps.  A shed
        # request that never got stamped (admission-less shedding path)
        # falls back to its list membership.
        terminal: dict[str, int] = {}
        for r in finished:
            key = (r.terminal or TerminalState.FINISHED).value
            terminal[key] = terminal.get(key, 0) + 1
        for r in self.shed:
            key = (r.terminal or TerminalState.SHED).value
            terminal[key] = terminal.get(key, 0) + 1
        for r in dropped:
            key = (r.terminal or TerminalState.DEADLINE_DROPPED).value
            terminal[key] = terminal.get(key, 0) + 1
        replica_stats = [self._replica_stat(rep) for rep in self.replicas]
        slo = {}
        if self.obs is not None:
            self._obs_final_sync(replica_stats)
            slo = self.obs.slo_report()
        return ClusterSimResult(
            total_time=t, finished=finished, shed=list(self.shed),
            dropped=dropped, reenqueued=self.reenqueued,
            handoff_stats=self.channel.stats(),
            replica_stats=replica_stats,
            health={"failures": list(self.monitor.failures),
                    "stragglers": list(self.monitor.stragglers)},
            admission=(self.admission.stats() if self.admission is not None
                       else {}),
            autoscale=(self.autoscaler.stats() if self.autoscaler is not None
                       else {}),
            policy=(self.policy_store.stats() if self.policy_store is not None
                    else {}),
            prefix=self._prefix_stats(),
            readmitted=self.readmitted,
            terminal=terminal, slo=slo)

    def _obs_final_sync(self, replica_stats: list[dict]) -> None:
        """End-of-run registry sync for cumulative component counters that
        have no natural mid-run emission point: radix cache totals,
        replica-seconds, prefix-directory epoch."""
        m = self.obs
        for rep in self.replicas:
            if rep.radix is not None:
                st = rep.radix.stats()
                lbl = {"replica": rep.replica_id}
                m.gauge("kv_prefix_lookups", lbl, float(st.get("lookups", 0)))
                m.gauge("kv_prefix_hit_blocks", lbl,
                        float(st.get("hit_blocks", 0)))
                m.gauge("kv_prefix_evicted", lbl, float(st.get("evicted", 0)))
                m.gauge("kv_prefix_hit_rate", lbl,
                        float(st.get("hit_rate", 0.0)))
        m.gauge("replica_seconds_total",
                v=sum(s.get("replica_seconds", 0.0) for s in replica_stats))
        if self.prefix_directory is not None:
            st = self.prefix_directory.stats()
            m.gauge("prefix_directory_epoch", v=float(st.get("epoch", 0)))

    def _prefix_stats(self) -> dict:
        caches = {rep.replica_id: rep.radix.stats()
                  for rep in self.replicas if rep.radix is not None}
        if not caches and self.prefix_directory is None:
            return {}
        out = {"caches": caches,
               "saved_tokens": sum(rep.prefix_saved_tokens
                                   for rep in self.replicas),
               "kv": self.monitor.kv_stats()}
        if self.prefix_directory is not None:
            out["directory"] = self.prefix_directory.stats()
        return out

    def _in_system(self) -> int:
        return sum(rep.sched.waiting() + rep.inflight() + len(rep.inbox)
                   + len(rep.outbox) for rep in self.replicas) \
            + len(self.backlog)

    def _replica_stat(self, rep: ReplicaModel) -> dict:
        """Per-replica result row (see ``ClusterSimResult.replica_stats``)."""
        stat = {"replica_id": rep.replica_id, "role": rep.role,
                "speed": rep.speed, "alive": rep.alive,
                "draining": rep.draining, "served": rep.served,
                "preemptions": rep.preemptions, "ticks": rep.ticks,
                "busy_time": rep.busy_time,
                "kv_occupancy": rep.kv_occupancy(),
                "born": rep.born, "died": rep.died,
                "replica_seconds": max(
                    0.0, (rep.died if rep.died is not None else self.now)
                    - rep.born)}
        if rep.radix is not None:
            stat["prefix_cache"] = rep.radix.stats()
            stat["prefix_saved_tokens"] = rep.prefix_saved_tokens
        return stat


def run_router_comparison(make_replicas: Callable[[], list[ReplicaModel]],
                          routers: dict[str, Router],
                          workload: list[Request], cost: CostModel,
                          scenario: Sequence[ScenarioEvent] = (),
                          admission_factory: Optional[
                              Callable[[], AdmissionController]] = None,
                          ) -> dict[str, ClusterSimResult]:
    """Run the same workload through several routers over fresh replica
    fleets (deep-copied requests each time, mirroring core.run_comparison)."""
    out = {}
    for name, router in routers.items():
        reqs = copy.deepcopy(workload)
        sim = ClusterSimulator(
            make_replicas(), router, cost,
            admission=admission_factory() if admission_factory else None)
        out[name] = sim.run(reqs, scenario=copy.deepcopy(list(scenario)))
    return out
