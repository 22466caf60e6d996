"""Fleet of real engines — the cluster data plane over live ``ServingEngine``s.

The DES half of the repo drives ``ReplicaModel`` simulacra through the
router / health / admission / prefix planes; this module puts N *live*
torch engines (the port's ``serving.engine.ServingEngine``) behind the very
same planes:

* :class:`EngineReplica` — the adapter.  It duck-types the routing surface
  of :class:`~repro_torch.cluster.replica.ReplicaModel` (``accepts_prefill`` /
  ``scheduler_snapshot`` / ``prefix_probe`` / ``kv_occupancy`` / …) over a
  :class:`~repro_torch.serving.engine.ServingEngine`, so ``EWSJFRouter.select``
  runs unchanged.  Each adapter additionally exposes ``router_cost``: the
  engine's own :class:`~repro_torch.core.cost_model.CalibratedCostModel` once its
  attached :class:`~repro_torch.obs.calibration.CostCalibrator` has converged
  classes, the shared roofline before that — so routing prices work on each
  engine with that engine's measured cost regime (``cost_rev`` bumps on
  refresh, invalidating the router's per-queue work memo).

* :class:`EngineFleet` — the live driver (the engine-backed mirror of
  ``ClusterSimulator.run``): one shared clock across engines, router-based
  ingestion, directory prefix sync (engines advertise ``hot_adverts`` from
  their radix; forgotten on drain/death), heartbeat-driven health rounds
  (an engine whose beacon lapses is failed and its in-flight requests are
  re-admitted through the admission defer/retry pump — never dropped), and
  **real host-KV handoffs**: a router-planned ``PrefixFetch`` ships actual
  host-side KV blocks from the holder engine's ``_node_kv`` store (views of
  its pinned per-layer runs) into the destination's radix (pool blocks
  allocated for real; the destination packs them into one run per layer),
  with bytes charged
  against the shared :class:`~repro_torch.kvplane.topology.LinkTopology`; the
  destination's ``_attach_prefix`` then copies them into the slot caches at
  dispatch and charges the copy via ``attach_copy`` calibration.

Invariants held by construction (and property-checked by
``tests/test_engine_fleet.py``): no request lost or double-dispatched;
every pinned prefix path unpinned at terminal state; per-engine
``BlockPool`` conservation across handoffs (imports allocate real blocks on
the destination pool); the directory never advertises a dead engine past
one sync round; the router never dispatches to a drained engine.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.cost_model import CalibratedCostModel, CostModel
from ..core.types import Request, RequestState
from ..kvplane.directory import PrefixDirectory
from ..kvplane.radix import chain_block_hashes
from ..kvplane.topology import LinkTopology
from ..serving.engine import ServingEngine
from .admission import AdmissionController
from .health import HealthConfig, HealthMonitor
from .replica import ReplicaParams
from .router import EWSJFRouter, Router


def _host_bytes(obj) -> int:
    """Recursive byte count of a host KV block pytree (dict/list of torch
    tensors) — the *actual* bytes a handoff ships, vs the cost model's
    per-token estimate.  An exported block is a view into a run of blocks
    published together, so each tensor counts its own elements, never the
    run's whole storage."""
    if isinstance(obj, dict):
        return sum(_host_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_host_bytes(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    return int(getattr(obj, "nbytes", 0))


class EngineReplica:
    """Routing-surface adapter: one live ``ServingEngine`` as a first-class
    member of the cluster planes.  Implements the ``ReplicaModel`` duck
    type the routers consume; holds no scheduling state of its own — every
    read delegates to the engine."""

    role = "unified"

    def __init__(self, engine: ServingEngine, cost: CostModel | None = None,
                 speed: float = 1.0, calibrated_routing: bool = True):
        self.engine = engine
        self.speed = speed
        self.base_cost = cost or CostModel()
        self.calibrated_routing = calibrated_routing
        # ReplicaParams mirror of the EngineConfig, for the router's
        # ``replica.p.block_size`` reads (docs/ENGINE.md calibration table).
        e = engine.e
        self.p = ReplicaParams(
            max_num_seqs=e.max_slots,
            max_prefill_tokens=e.max_prefill_tokens,
            kv_pool_tokens=e.kv_pool_tokens,
            block_size=e.block_size,
            decode_steps_per_tick=e.decode_steps_per_tick,
            enable_prefix_cache=e.enable_prefix_cache)
        self.kv_ewma = 0.0              # written back by fleet health rounds
        self.inbox: list = []           # no disaggregation on the live path
        self.outbox: list = []          # (router iterates both — keep empty)
        # Per-engine calibrated routing cost: refreshed from the engine's
        # calibrator each health round; ``cost_rev`` keys the router memo.
        self.cost_rev = 0
        self._router_cost: Optional[CostModel] = None
        self._last_correction: Optional[dict] = None

    # ---- identity --------------------------------------------------------

    @property
    def replica_id(self) -> int:
        """Fleet identity: the engine's configured ``engine_id``."""
        return self.engine.e.engine_id

    @property
    def sched(self):
        """The engine's live scheduler (router snapshot/version surface)."""
        return self.engine.sched

    @property
    def radix(self):
        """The engine's radix prefix index (None with the cache off)."""
        return self.engine.radix

    @property
    def alive(self) -> bool:
        """Engine liveness flag (cleared by ``fail`` / completed drain)."""
        return self.engine.alive

    @property
    def draining(self) -> bool:
        """Whether the engine is finishing in-flight work, taking no new."""
        return self.engine.draining

    # ---- routing surface -------------------------------------------------

    def schedulable(self) -> bool:
        """Alive and not draining: a valid routing target.  Heartbeat
        freshness is folded into ``alive`` by the fleet's health rounds, so
        a lapsed engine is excluded within one round."""
        return self.engine.alive and not self.engine.draining

    def accepts_prefill(self) -> bool:
        """Router surface: new prefills land only on schedulable engines."""
        return self.schedulable()

    def accepts_decode(self) -> bool:
        """Router surface: decode placement mirrors prefill eligibility."""
        return self.schedulable()

    def kv_occupancy(self) -> float:
        """Instantaneous KV pool utilization of the live engine (0–1)."""
        return self.engine.pool.utilization

    def inflight(self) -> int:
        """Decode slots currently occupied on the engine."""
        return len(self.engine.slot_state)

    def prefix_probe(self, hashes) -> int:
        """Blocks of ``hashes`` resident in the engine radix (no LRU touch)."""
        if self.engine.radix is None or not hashes:
            return 0
        return self.engine.radix.match(hashes, touch=False).blocks

    def prefix_adverts(self) -> dict:
        """Hottest-K cached prefixes for directory publication."""
        if self.engine.radix is None:
            return {}
        return self.engine.radix.hot_adverts(self.p.prefix_advertise_k)

    def scheduler_snapshot(self, now: float, fresh: bool = False):
        """Queue-structure snapshot from the live scheduler (cached unless
        ``fresh`` — same contract as ``ReplicaModel``)."""
        if fresh:
            return self.engine.sched.snapshot(now)
        return self.engine.sched.snapshot_cached(now)

    def exec_residual(self, now: float) -> float:
        """A live engine blocks the driver for the duration of its step —
        by the time the router runs, nothing is mid-step."""
        return 0.0

    def backlog_cost(self, now: float) -> float:
        """Coarse queued-work estimate (LeastLoadedRouter surface)."""
        cost = self.router_cost or self.base_cost
        snap = self.engine.sched.snapshot_cached(now)
        queued = sum(cost.c_prefill(q.mean_len) * q.depth
                     for q in snap.queues if q.depth)
        decode = sum(max(st.req.max_new_tokens - st.req.generated, 0)
                     * cost.decode_step_time(1, int(self.engine.slot_pos[s]))
                     for s, st in self.engine.slot_state.items())
        return (queued + decode) / max(self.speed, 1e-6)

    def predicted_step_seconds(self) -> Optional[float]:
        """No learned step predictor on the live path (None → fallback)."""
        return None

    def predicted_decode_seconds(self) -> Optional[float]:
        """No learned decode predictor on the live path (None → fallback)."""
        return None

    def has_work(self) -> bool:
        """Anything queued, prefilling, or decoding on the engine."""
        return self.engine.has_work()

    # ---- calibrated routing cost -----------------------------------------

    @property
    def router_cost(self) -> Optional[CostModel]:
        """Cost model the router should price this replica's work with:
        the engine's calibrated fit once converged, None (→ the router's
        shared roofline) before convergence or with calibration off."""
        if not self.calibrated_routing:
            return None
        return self._router_cost

    def refresh_cost(self) -> bool:
        """Re-read the engine calibrator's fitted correction; rebuild the
        calibrated model and bump ``cost_rev`` when it changed (the router
        memo keys on the revision, so cached per-queue works reprice).
        Returns True when the cost model was refreshed."""
        calib = getattr(self.engine.obs, "calib", None) \
            if self.engine.obs is not None else None
        if calib is None:
            return False
        corr = calib.correction()
        if not corr or corr == self._last_correction:
            return False
        self._last_correction = corr
        self._router_cost = CalibratedCostModel.from_fit(self.base_cost,
                                                         corr)
        self.cost_rev += 1
        return True

    # ---- request path / lifecycle ----------------------------------------

    def submit(self, req: Request, now: float) -> None:
        """Dispatch one routed request into the live engine."""
        self.engine.add_request(req)

    def heartbeat(self) -> dict:
        """The engine's beacon payload (folded into ``HealthMonitor``)."""
        return self.engine.heartbeat()

    def fail(self) -> list[Request]:
        """Hard-kill the engine; returns orphaned requests to re-admit."""
        return self.engine.fail()

    def start_drain(self) -> list[Request]:
        """Begin graceful drain; returns queued requests to re-route."""
        return self.engine.start_drain()

    def dispatch_order(self) -> list[int]:
        """Request ids in engine dispatch order (conformance surface)."""
        return [rid for _, rid in self.engine.dispatch_log]


@dataclass
class FleetStats:
    """Live-path counters the DES result object reports analytically."""
    routed: int = 0
    reenqueued: int = 0
    readmitted: int = 0
    failures: list = field(default_factory=list)
    drains: list = field(default_factory=list)
    prefix_fetches: int = 0
    prefix_fetch_blocks: int = 0
    prefix_fetch_bytes: int = 0          # actual host bytes shipped
    prefix_fetch_exposed_s: float = 0.0  # topology-exposed transfer seconds


class EngineFleet:
    """Live driver: N engines on one clock behind the cluster planes.

    Construct with engines whose ``EngineConfig.engine_id``s are distinct,
    then either call :meth:`serve` with a trace (the engine-backed mirror
    of ``ClusterSimulator.run``) or drive :meth:`submit` / :meth:`step` /
    :meth:`health_round` / :meth:`prefix_sync` manually (the conformance
    tests do, for deterministic interleavings)."""

    def __init__(self, engines: Sequence[ServingEngine],
                 router: Router | None = None,
                 cost: CostModel | None = None,
                 monitor: HealthMonitor | None = None,
                 directory: Optional[PrefixDirectory] = None,
                 topology: Optional[LinkTopology] = None,
                 admission: Optional[AdmissionController] = None,
                 calibrated_routing: bool = True):
        engines = list(engines)
        ids = [e.e.engine_id for e in engines]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate engine_ids: {ids}")
        sizes = {e.e.block_size for e in engines}
        if len(sizes) != 1:
            raise ValueError(f"mixed block sizes across the fleet: {sizes}")
        self.block_size = sizes.pop()
        self.cost = cost or CostModel()
        self.router = router or EWSJFRouter(cost=self.cost)
        self.monitor = monitor or HealthMonitor(HealthConfig())
        self.directory = directory
        self.topology = topology if topology is not None else (
            LinkTopology() if directory is not None else None)
        self.admission = admission
        if isinstance(self.router, EWSJFRouter):
            if directory is not None and self.router.directory is None:
                self.router.directory = directory
            if self.topology is not None and self.router.topology is None:
                self.router.topology = self.topology
        self.replicas = [EngineReplica(e, cost=self.cost,
                                       calibrated_routing=calibrated_routing)
                         for e in engines]
        self._by_id = {rep.replica_id: rep for rep in self.replicas}
        # One clock: rebase every engine's t0 so ``engine.now()`` and
        # ``fleet.now()`` agree (heartbeats, dispatch logs, SLO reports all
        # land on the same axis).
        self._t0 = time.monotonic()
        for e in engines:
            e._t0 = self._t0
        self.shed: list[Request] = []        # fleet-level permanent sheds
        self.backlog: list[Request] = []     # routable-later (no live target)
        self.stats = FleetStats()
        self._last_health = float("-inf")
        self._suppressed: set[int] = set()   # test hook: beacon suppression
        # Initial beacons: every engine is known-alive at t0, so the first
        # health round has a baseline to age against.
        now0 = self.now()
        for rep in self.replicas:
            self.monitor.observe_engine_heartbeat(rep.heartbeat(), now=now0)

    # ---- clock -----------------------------------------------------------

    def now(self) -> float:
        """Seconds since fleet construction — the axis every engine shares."""
        return time.monotonic() - self._t0

    # ---- ingestion -------------------------------------------------------

    def _stamp(self, req: Request) -> None:
        """Fleet-level ingress stamp: materialize prompt tokens and chain
        their block hashes *before* routing, so the router's prefix terms
        (directory lookups, local probes) see every request — the same
        stamp ``ServingEngine._stamp_prefix`` applies, hoisted to the
        fleet so cross-engine routing is prefix-aware."""
        if req.prompt_tokens is None:
            rng = np.random.default_rng(req.request_id)
            vocab = self.replicas[0].engine.cfg.vocab_size
            req.prompt_tokens = rng.integers(
                0, vocab, size=(req.prompt_len,)).astype(np.int32)
        else:
            req.prompt_tokens = np.asarray(req.prompt_tokens, dtype=np.int32)
        if req.prompt_hashes is None:
            req.prompt_hashes = chain_block_hashes(
                req.prompt_tokens.tolist(), self.block_size)

    def submit(self, req: Request, now: Optional[float] = None) -> bool:
        """Admission + routing for one arrival (the live ``ingest``).
        Returns False when the request was deferred or shed; deferred
        requests ride the admission defer/retry pump."""
        now = self.now() if now is None else now
        self._stamp(req)
        if self.admission is not None:
            pool = [r for r in self.replicas if r.accepts_prefill()]
            est = (min((self.router.route_cost(r, req, now) for r in pool),
                       default=float("inf"))
                   if isinstance(self.router, EWSJFRouter) and pool
                   else 0.0)
            dec = self.admission.admit(req, now, est)
            if not dec.admitted:
                if dec.reason != "defer":
                    req.state = RequestState.FAILED
                    req.finish_time = now
                    self.shed.append(req)
                return False
        self._route(req, now)
        return True

    def _route(self, req: Request, now: float) -> None:
        rep = self.router.select(self.replicas, req, now)
        if rep is None:
            self.backlog.append(req)
            return
        if req.prefix_fetch is not None:
            self._handoff(req, rep, now)
        rep.submit(req, now)
        self.stats.routed += 1

    # ---- host-KV handoff -------------------------------------------------

    def _handoff(self, req: Request, dst: EngineReplica,
                 now: float) -> None:
        """Execute a router-planned remote prefix fetch for real: ship host
        KV blocks from the holder engine into the destination's radix
        (destination pool blocks allocated by the insert — the pool stays
        the one accountant), charging the transfer against the shared link
        topology.  The destination's ``_attach_prefix`` finds the blocks
        locally at dispatch and charges the slot copy via ``attach_copy``
        calibration.  A dead/drained source, or one whose cache churned the
        blocks away, degrades to a local-only prefill — never an error."""
        fetch, req.prefix_fetch = req.prefix_fetch, None
        src = self._by_id.get(fetch.src_replica)
        if (src is None or not src.alive or src.draining
                or req.prompt_hashes is None):
            return
        want = min(int(fetch.blocks), len(req.prompt_hashes))
        blocks_kv = src.engine.export_prefix_blocks(req.prompt_hashes, want)
        if not blocks_kv:
            return
        exposed = 0.0
        model_bytes = (len(blocks_kv) * self.block_size
                       * self.cost.model.kv_bytes_per_token)
        if self.topology is not None:
            exposed = self.topology.fetch(model_bytes, src.replica_id,
                                          dst.replica_id, now)
        landed = dst.engine.import_prefix_blocks(
            req.prompt_hashes[:want], blocks_kv)
        self.stats.prefix_fetches += 1
        self.stats.prefix_fetch_blocks += landed
        self.stats.prefix_fetch_bytes += _host_bytes(blocks_kv[:landed])
        self.stats.prefix_fetch_exposed_s += exposed

    # ---- control-plane rounds --------------------------------------------

    def suppress_heartbeat(self, engine_id: int, on: bool = True) -> None:
        """Test hook: stop folding an engine's beacons into the monitor so
        a heartbeat lapse can be staged deterministically."""
        if on:
            self._suppressed.add(engine_id)
        else:
            self._suppressed.discard(engine_id)

    def health_round(self, now: Optional[float] = None) -> list[int]:
        """One health round: fold fresh beacons, fail every engine whose
        beacon lapsed past the monitor's ``heartbeat_timeout`` (orphans are
        re-admitted through the defer/retry pump), write the smoothed KV
        view back onto the adapters, refresh calibrated routing costs.
        Returns the engine ids failed this round."""
        now = self.now() if now is None else now
        self._last_health = now
        for rep in self.replicas:
            if rep.alive and rep.replica_id not in self._suppressed:
                self.monitor.observe_engine_heartbeat(rep.heartbeat(),
                                                      now=now)
        failed: list[int] = []
        for rep in self.replicas:
            if rep.alive and not self.monitor.engine_alive(rep.replica_id,
                                                           now):
                self._on_fail(rep, now)
                failed.append(rep.replica_id)
        for rep in self.replicas:
            rep.kv_ewma = self.monitor.kv_ewma.get(rep.replica_id, 0.0)
            rep.refresh_cost()
        return failed

    def _reenqueue(self, orphans: list[Request], now: float) -> None:
        for req in orphans:
            self.stats.reenqueued += 1
            if self.admission is not None:
                if not self.admission.park(req, now):
                    req.state = RequestState.FAILED
                    req.finish_time = now
                    self.shed.append(req)
            else:
                self.backlog.append(req)

    def _on_fail(self, rep: EngineReplica, now: float) -> None:
        self.stats.failures.append(rep.replica_id)
        orphans = rep.fail()
        if self.directory is not None:
            self.directory.forget(rep.replica_id)
        self._reenqueue(orphans, now)

    def fail_engine(self, engine_id: int,
                    now: Optional[float] = None) -> None:
        """Scenario hook: hard-kill one engine (crash injection)."""
        now = self.now() if now is None else now
        rep = self._by_id[engine_id]
        if rep.alive:
            self._on_fail(rep, now)

    def drain_engine(self, engine_id: int,
                     now: Optional[float] = None) -> None:
        """Graceful drain: stop dispatch, let slots finish, forget adverts,
        re-route queued work."""
        now = self.now() if now is None else now
        rep = self._by_id[engine_id]
        if not rep.alive or rep.draining:
            return
        self.stats.drains.append(engine_id)
        queued = rep.start_drain()
        if self.directory is not None:
            self.directory.forget(engine_id)
        self._reenqueue(queued, now)

    def prefix_sync(self, now: Optional[float] = None) -> None:
        """One directory round: every live caching engine advertises its
        hottest radix paths, then the directory merges (dead publishers age
        out; ``forget`` already dropped failed/drained ones immediately)."""
        if self.directory is None:
            return
        now = self.now() if now is None else now
        for rep in self.replicas:
            if rep.alive and not rep.draining and rep.radix is not None:
                self.directory.publish(rep.replica_id, rep.prefix_adverts(),
                                       now)
        self.directory.merge(now)

    def _pump(self, now: float) -> None:
        """Drain the admission defer/retry queue through re-admission +
        routing (the fleet-level ``_pump_retries``)."""
        if self.admission is None or not self.admission.retry_pending():
            return
        due, expired = self.admission.due_retries(now)
        self.shed.extend(expired)
        for req in due:
            dec = self.admission.admit(req, now, 0.0, retry=True)
            if dec.admitted:
                self.stats.readmitted += 1
                self._route(req, now)
            elif dec.reason != "defer":
                req.state = RequestState.FAILED
                req.finish_time = now
                self.shed.append(req)

    # ---- main loop -------------------------------------------------------

    def step(self) -> None:
        """Tick every live engine once (round-robin over the fleet)."""
        for rep in self.replicas:
            if rep.alive:
                rep.engine.tick()

    def _accounted(self) -> int:
        n = len(self.shed)
        for rep in self.replicas:
            n += len(rep.engine.finished) + len(rep.engine.shed)
        return n

    def serve(self, requests: list[Request],
              max_ticks: int = 100_000) -> dict:
        """Serve a trace to completion across the fleet; returns
        :meth:`result`.  Arrivals are ingested by the shared clock;
        health / prefix-sync rounds run on their configured cadences."""
        pending = sorted(requests, key=lambda r: r.arrival_time)
        pi, n_total = 0, len(pending)
        for _ in range(max_ticks):
            now = self.now()
            while pi < n_total and pending[pi].arrival_time <= now:
                self.submit(pending[pi], now)
                pi += 1
            self._pump(now)
            if self.backlog:
                still: list[Request] = []
                for req in self.backlog:
                    rep = self.router.select(self.replicas, req, now)
                    if rep is None:
                        still.append(req)
                    else:
                        if req.prefix_fetch is not None:
                            self._handoff(req, rep, now)
                        rep.submit(req, now)
                        self.stats.routed += 1
                self.backlog = still
            if now - self._last_health >= self.monitor.cfg.check_interval:
                self.health_round(now)
            if self.directory is not None and self.directory.due(now):
                self.prefix_sync(now)
            self.step()
            if (self._accounted() >= n_total and not self.backlog
                    and pi >= n_total
                    and (self.admission is None
                         or not self.admission.retry_pending())):
                break
        return self.result()

    # ---- reporting -------------------------------------------------------

    def finished(self) -> list[Request]:
        """All finished requests across the fleet (engine order)."""
        out: list[Request] = []
        for rep in self.replicas:
            out.extend(rep.engine.finished)
        return out

    def result(self) -> dict:
        """Run summary in the shape bench/report code expects: fleet SLO
        report (shared percentile path), per-engine stats, control-plane
        telemetry."""
        from ..obs.slo import slo_or_fallback
        fin = self.finished()
        all_shed = list(self.shed)
        per_engine = {}
        for rep in self.replicas:
            e = rep.engine
            all_shed.extend(e.shed)
            per_engine[rep.replica_id] = {
                "alive": e.alive, "draining": e.draining,
                "finished": len(e.finished), "shed": len(e.shed),
                "dispatched": len(e.dispatch_log),
                "prefix_saved_tokens": e.prefix_saved_tokens,
                "preemptions": e.preemptions,
                "kv_occupancy": e.pool.utilization,
            }
        return {
            "finished": len(fin),
            "shed": len(all_shed),
            "slo": slo_or_fallback(None, fin),
            "elapsed_s": self.now(),
            "routed": self.stats.routed,
            "reenqueued": self.stats.reenqueued,
            "readmitted": self.stats.readmitted,
            "failures": list(self.stats.failures),
            "drains": list(self.stats.drains),
            "prefix_fetches": self.stats.prefix_fetches,
            "prefix_fetch_blocks": self.stats.prefix_fetch_blocks,
            "prefix_fetch_bytes": self.stats.prefix_fetch_bytes,
            "prefix_fetch_exposed_s": self.stats.prefix_fetch_exposed_s,
            "engines": per_engine,
            "directory": (self.directory.stats()
                          if self.directory is not None else {}),
            "topology": (self.topology.stats()
                         if self.topology is not None else {}),
            "admission": (self.admission.stats()
                          if self.admission is not None else {}),
        }
