"""Pluggable multi-replica routing policies.

The router is the request-level layer *above* the per-replica schedulers
(the paper positions EWSJF upstream of execution-level scheduling; Bari et
al. show routing and scheduling must be analyzed jointly).  Three policies:

  * ``RoundRobinRouter``  — cycles over schedulable replicas (the usual
    load-balancer default, blind to backlog and heterogeneity);
  * ``LeastLoadedRouter`` — join-the-shortest-queue on a coarse work
    estimate (queued prefill seconds + in-flight decode residual, scaled by
    replica speed) — uses scheduler *totals* only;
  * ``EWSJFRouter``       — EWSJF-aware: reads each replica's
    ``SchedulerSnapshot`` (queue structure + density-weighted head scores)
    and estimates the *marginal start delay this request would see there*:
    FIFO work ahead of it in its own interval queue, plus score-weighted
    contention from competing queues, plus executor residual and a KV
    pressure penalty.  Short requests therefore avoid replicas whose short
    queue is deep or whose long-queue heads have accumulated urgency —
    interference the totals-only policies cannot see.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.cost_model import CostModel
from ..core.partition import edge_divergence
from ..kvplane.topology import PrefixFetch
from .replica import ReplicaModel

# Cost-term names on the traced route event, in ``_last_terms`` order.
_TERM_KEYS = ("ahead", "contention", "resid", "decode_drag", "stalled",
              "kv_occ", "own_prefill", "total")


class Router:
    """Base router: pick a prefill-capable replica for a new request, and a
    decode replica for a KV handoff."""

    name = "base"

    def select(self, replicas: Sequence[ReplicaModel], req,
               now: float) -> Optional[ReplicaModel]:
        """Pick a prefill-capable replica for ``req`` (None = no capacity)."""
        raise NotImplementedError

    def select_decode(self, replicas: Sequence[ReplicaModel], handoff,
                      now: float) -> Optional[ReplicaModel]:
        """Decode-pool placement for a handoff: least KV-pressure, then
        least in-flight per unit speed (shared by all policies — decode
        placement is a memory-balancing problem, not a queueing one).  The
        speed normalization matters once pools are asymmetric: a role-aware
        scale-up may add decode replicas at a different speed tier, and raw
        in-flight counts would keep loading the slow ones."""
        pool = [r for r in replicas if r.accepts_decode()]
        if not pool:
            return None
        # Prediction plane: when every candidate can price its decode
        # batch in predicted KV-seconds (predictor wired + stamps present),
        # balance on that — a replica with few-but-long decodes stops
        # looking cheaper than one with many-but-short.  Any candidate
        # without the signal (no predictor / all abstained) drops the whole
        # pool back to the length-blind count, keeping the comparison
        # unit-coherent and predictor-off bit-identical.
        pds = [r.predicted_decode_seconds() for r in pool]
        if all(p is not None for p in pds):
            by_id = {r.replica_id: p for r, p in zip(pool, pds)}
            return min(pool, key=lambda r: (r.kv_occupancy(),
                                            by_id[r.replica_id],
                                            r.replica_id))
        return min(pool, key=lambda r: (r.kv_occupancy(),
                                        (r.inflight() + len(r.inbox))
                                        / max(r.speed, 1e-6),
                                        r.replica_id))


class RoundRobinRouter(Router):
    """Cycles over schedulable replicas — backlog- and speed-blind."""
    name = "round_robin"

    def __init__(self):
        self._i = 0

    def select(self, replicas, req, now):
        """Next prefill-capable replica in cyclic order."""
        pool = [r for r in replicas if r.accepts_prefill()]
        if not pool:
            return None
        r = pool[self._i % len(pool)]
        self._i += 1
        return r


class LeastLoadedRouter(Router):
    """Join-the-shortest-queue on a coarse speed-scaled work estimate."""
    name = "least_loaded"

    def select(self, replicas, req, now):
        """Replica with the least queued + residual work per unit speed."""
        pool = [r for r in replicas if r.accepts_prefill()]
        if not pool:
            return None
        return min(pool, key=lambda r: (r.exec_residual(now)
                                        + r.backlog_cost(now), r.replica_id))


class EWSJFRouter(Router):
    """EWSJF-aware router with an incremental state cache.

    The expensive inputs to ``route_cost`` — per-queue aggregate work terms
    derived from each replica's ``SchedulerSnapshot`` — are cached and
    invalidated *event-driven*: replicas' schedulers publish a monotonic
    ``version`` bumped on enqueue/dispatch/finish (delta publication, see
    ``BaseScheduler._publish``), so ``select`` is a cached-cost lookup
    instead of an O(replicas·waiting) snapshot rebuild per arrival.  Only
    the O(1)-per-queue time-dependent terms (head scores, executor
    residual, KV occupancy) are read fresh, so routing decisions are
    *identical* to the uncached path (``use_cache=False``, kept for
    verification and the control-plane overhead benchmark)."""

    name = "ewsjf"

    def __init__(self, cost: CostModel | None = None,
                 kv_pressure_knee: float = 0.8,
                 kv_pressure_slope: float = 5.0,
                 contention_horizon: int = 8,
                 use_cache: bool = True,
                 policy_store=None,
                 directory=None, topology=None):
        self.cost = cost or CostModel()
        self.kv_pressure_knee = kv_pressure_knee
        self.kv_pressure_slope = kv_pressure_slope
        # how many waiting requests per competing queue are assumed to run
        # before our queue's head gets picked (bounded lookahead)
        self.contention_horizon = contention_horizon
        self.use_cache = use_cache
        # KV plane (prefix reuse): with a fleet PrefixDirectory and/or
        # per-replica radix caches, ``route_cost`` consumes *effective*
        # lengths — a replica already holding the request's prefix only
        # pays the uncached suffix (local hit), a remote holder pays the
        # suffix plus the modeled (compute-overlapped) KV transfer — so
        # routing steers requests toward the KV they can reuse.  Both None
        # ⇒ the prefix terms vanish and decisions are identical to the
        # prefix-blind router.
        self.directory = directory
        self.topology = topology
        # Optional fleet PolicyStore: when set, replicas whose installed
        # partition diverges from the global map pay a mild cost factor
        # (see _alignment_factor) so routing steers toward structure that
        # agrees with the fleet policy.
        self.policy_store = policy_store
        self.alignment_penalty = 0.25
        # replica_id -> (installed queue-bounds key, policy epoch, factor)
        self._align_memo: dict[int, tuple[tuple, int, float]] = {}
        # replica_id -> ((sched version, cost rev), {queue_id: (work, capped)})
        self._work_memo: dict[int, tuple[tuple, dict[int, tuple[float, float]]]] = {}
        # Observability handle (obs.Observability), wired by the cluster
        # simulator.  With obs on, ``select`` sets ``_stash_terms`` around
        # its min() scan so ``route_cost`` drops each candidate's term
        # breakdown into ``_terms_by_rep`` (a tuple build + dict store per
        # candidate — far cheaper than recomputing the winner's cost) and
        # the winner's row lands on the route event / cost histogram.
        # With obs off the stash flag is a single false check and the
        # min() fast path is untouched.  ``_route_h``/``_route_cost_h``
        # cache pre-bound metric handles (wired once per run).
        self.obs = None
        self._stash_terms = False
        self._terms_by_rep: dict[int, tuple] = {}
        self._route_h: dict = {}
        self._route_cost_h = None

    def select(self, replicas, req, now):
        """Minimum marginal-start-delay replica (see ``route_cost``); stamps
        the winner's prefix-reuse plan onto the request."""
        pool = [r for r in replicas if r.accepts_prefill()]
        if not pool:
            return None
        if len(self._work_memo) > len(replicas) \
                or len(self._align_memo) > len(replicas):
            # evict memo entries for replicas that failed/drained away
            # (each memo under its own size check: with use_cache=False the
            # work memo stays empty while the alignment memo still fills)
            live = {r.replica_id for r in replicas}
            self._work_memo = {k: v for k, v in self._work_memo.items()
                               if k in live}
            self._align_memo = {k: v for k, v in self._align_memo.items()
                                if k in live}
        obs = self.obs
        if obs is None:
            best = min(pool, key=lambda r: (self.route_cost(r, req, now),
                                            r.replica_id))
            self._annotate_prefix(best, req)
            return best
        # Instrumented path: identical min() scan, with route_cost dropping
        # each candidate's term tuple into _terms_by_rep on the way.
        self._terms_by_rep.clear()
        self._stash_terms = True
        best = min(pool, key=lambda r: (self.route_cost(r, req, now),
                                        r.replica_id))
        self._stash_terms = False
        self._annotate_prefix(best, req)
        terms = self._terms_by_rep.get(best.replica_id)
        trace = obs.trace
        if trace is not None:
            data = (dict(zip(_TERM_KEYS, terms))
                    if terms is not None else {})
            data["n_pool"] = len(pool)
            trace.emit("route", now, req.request_id, best.replica_id,
                       0.0, data)
        m = obs.metrics
        if m is not None:
            h = self._route_h.get(best.replica_id)
            if h is None:
                h = self._route_h[best.replica_id] = m.counter(
                    "route_decisions_total", {"replica": best.replica_id})
            h.inc()
            if self._route_cost_h is None:
                self._route_cost_h = m.hist("route_cost_seconds")
            if terms is not None:
                self._route_cost_h.observe(terms[7])
        return best

    # ---- per-replica cost models -----------------------------------------

    def _replica_cost(self, replica) -> CostModel:
        """Cost model pricing work on *this* replica: a live engine replica
        whose calibrator converged exposes its own ``CalibratedCostModel``
        fit via ``router_cost`` (``cluster.engine_fleet.EngineReplica``);
        everything else — every DES ``ReplicaModel`` in particular, which
        has no such attribute — uses the router's shared roofline, keeping
        the legacy path bit-identical."""
        rc = getattr(replica, "router_cost", None)
        return self.cost if rc is None else rc

    # ---- KV plane (prefix reuse) ----------------------------------------

    def _prefix_active(self, replica: ReplicaModel, req) -> bool:
        return bool(req.prompt_hashes) and (replica.radix is not None
                                            or self.directory is not None)

    def _prefix_terms(self, replica: ReplicaModel, req
                      ) -> tuple[int, Optional[PrefixFetch], float]:
        """Best prefix-reuse option for ``req`` on ``replica``:
        ``(cached_tokens, fetch_plan, exposed_transfer_s)``.  Local radix
        blocks are free; a deeper remotely advertised prefix is worth
        fetching only when the suffix-cost saving beats the exposed
        (compute-overlapped) transfer time — and never onto a replica whose
        KV pool is already near exhaustion (health-monitor-smoothed
        occupancy), where the fetched blocks would only churn."""
        L = int(req.prompt_len)
        hashes = req.prompt_hashes
        bs = replica.p.block_size
        cost = self._replica_cost(replica)
        local = replica.prefix_probe(hashes)
        cached = min(local * bs, L - 1) if local else 0
        plan: Optional[PrefixFetch] = None
        exposed = 0.0
        if self.directory is not None:
            occ = replica.kv_ewma if replica.kv_ewma > 0 \
                else replica.kv_occupancy()
            if occ <= self.kv_pressure_knee:
                src, blocks = self.directory.best_holder(
                    hashes, exclude=replica.replica_id)
                if src >= 0 and blocks > local:
                    n_bytes = ((blocks - local) * bs
                               * cost.model.kv_bytes_per_token)
                    ex = (self.topology.exposed_time(n_bytes, src,
                                                     replica.replica_id)
                          if self.topology is not None
                          else n_bytes / self.cost.link_bw)
                    remote_cached = min(blocks * bs, L - 1)
                    saving = (cost.prefill_cost(L, cached)
                              - cost.prefill_cost(L, remote_cached))
                    if saving > ex:
                        cached, plan, exposed = remote_cached, PrefixFetch(
                            src_replica=src, blocks=blocks,
                            kv_bytes=n_bytes), ex
        return cached, plan, exposed

    def _annotate_prefix(self, replica: ReplicaModel, req) -> None:
        """Stamp the winning replica's prefix plan onto the request: the
        scheduler queues/scores it by its effective length, and the replica
        executes the fetch at dispatch.  No-op when the KV plane is off."""
        if not self._prefix_active(replica, req):
            return
        cached, plan, _ = self._prefix_terms(replica, req)
        req.cached_len = cached
        req.prefix_fetch = plan

    def _queue_works(self, replica: ReplicaModel,
                     snap) -> dict[int, tuple[float, float]]:
        """Per-queue (total FIFO work, lookahead-capped work) in prefill
        seconds.  Time-independent between scheduler mutations, so cacheable
        keyed by the scheduler's published version (+ the replica's cost
        revision: a calibration refresh reprices cached works)."""
        key = (replica.sched.version, getattr(replica, "cost_rev", 0))
        if self.use_cache:
            hit = self._work_memo.get(replica.replica_id)
            if hit is not None and hit[0] == key:
                return hit[1]
        cost = self._replica_cost(replica)
        works = {}
        for q in snap.queues:
            unit = cost.c_prefill(max(q.mean_len, 1.0))
            works[q.queue_id] = (q.depth * unit,
                                 min(q.depth, self.contention_horizon) * unit)
        if self.use_cache:
            self._work_memo[replica.replica_id] = (key, works)
        return works

    def _alignment_factor(self, replica: ReplicaModel, snap) -> float:
        """Fleet-consistency factor from the global partition map: 1.0 when
        the replica's installed structure matches the fleet policy, growing
        with the mean relative distance of its interior edges from the
        global ones.  A diverged replica is about to be restructured by the
        next broadcast (queue rebuild + re-routing churn), so the router
        mildly prefers replicas whose structure already agrees with the
        fleet — keeping routing and per-replica queue structure aligned.
        Cached per (scheduler version, policy epoch).  NOTE: the request is
        always *costed* against the local queue it will actually join
        (interval containment); the global map never overrides that."""
        pol = self.policy_store.current()
        if pol is None:
            return 1.0
        # Memo key: the installed queue *structure*, not the scheduler's
        # mutation version — enqueue/dispatch bump the version every
        # arrival, but the factor only changes on repartition/adoption.
        key = tuple((q.lo, q.hi) for q in snap.queues)
        hit = self._align_memo.get(replica.replica_id)
        if hit is not None and hit[0] == key and hit[1] == pol.epoch:
            return hit[2]
        g = [b.hi for b in pol.boundaries[:-1] if b.hi != float("inf")]
        local = [q.hi for q in snap.queues[:-1] if q.hi != float("inf")]
        if not g:
            factor = 1.0               # no global structure to align with
        elif not local:
            # A single [0, ∞) queue when the fleet policy has structure is
            # the *maximally* diverged case (div capped at 1.0) — treating
            # it as aligned would steer traffic toward the least
            # structured replica.
            factor = 1.0 + self.alignment_penalty
        else:
            # Symmetric: local→global catches *misplaced* edges, while
            # global→local catches *missing* ones (a replica whose few
            # edges all sit on global positions is still under-structured
            # if the global map has edges it lacks).
            div = max(edge_divergence(local, g) or 0.0,
                      edge_divergence(g, local) or 0.0)
            factor = 1.0 + self.alignment_penalty * min(div, 1.0)
        self._align_memo[replica.replica_id] = (key, pol.epoch, factor)
        return factor

    def route_cost(self, replica: ReplicaModel, req, now: float) -> float:
        """Estimated delay-to-first-token contribution of routing ``req``
        to ``replica``.  With the KV plane active the request is costed at
        its *effective* length there (local hit → suffix only; remote hit →
        suffix plus overlapped KV-transfer) and the replica-dependent own
        prefill cost joins the comparison; with it off, the terms vanish
        and this is exactly the prefix-blind start-delay estimate."""
        L = float(req.prompt_len)
        cost = self._replica_cost(replica)
        own = 0.0
        if self._prefix_active(replica, req):
            cached, _, exposed = self._prefix_terms(replica, req)
            L = max(L - cached, 1.0)
            own = (cost.prefill_cost(float(req.prompt_len), cached)
                   / max(replica.speed, 1e-6)) + exposed
        snap = replica.scheduler_snapshot(now, fresh=not self.use_cache)
        works = self._queue_works(replica, snap)
        # Prediction plane: queue lookup happens in *work-length* space —
        # the per-replica scheduler queues stamped requests by work_len, so
        # the router must ask about the queue the request will actually
        # join.  Unstamped requests look up at L exactly as before.
        extra = req.predicted_extra if req.predicted_extra is not None else 0.0
        mine = snap.queue_for(L + extra)

        # 1) FIFO work ahead of us inside our own interval queue.
        ahead = works[mine.queue_id][0] if mine is not None else 0.0

        # 2) Cross-queue contention, weighted by the density scores the
        #    per-replica EWSJF scheduler will actually arbitrate with: a
        #    competing queue whose head outscores ours drains first.
        contention = 0.0
        my_head_score = mine.head_score if mine is not None else 0.0
        for q in snap.queues:
            if mine is not None and q.queue_id == mine.queue_id:
                continue
            if q.depth == 0:
                continue
            share = q.head_score / (q.head_score + my_head_score + 1e-9)
            contention += share * works[q.queue_id][1]

        # 3) Executor state: residual of the running step + decode drag.
        #    The drag charges ~one step per in-flight decode (near-term
        #    interference with *this* prefill's start), NOT the batch's
        #    full drain time — a replica holding one long decode must not
        #    look radioactive to prefill routing (the drain signal belongs
        #    to decode placement / admission, see select_decode).  With
        #    prediction stamps the per-step time is priced at the batch's
        #    predicted mid-drain KV footprint; the occupancy-based guess
        #    otherwise (abstain ≡ off).
        resid = replica.exec_residual(now)
        pstep = replica.predicted_step_seconds()
        if pstep is not None:
            decode_drag = replica.inflight() * pstep
        else:
            decode_drag = replica.inflight() * cost.decode_step_time(
                max(replica.inflight(), 1),
                max(replica.inflight(), 1) * max(L, 1.0))

        # 3b) Disaggregated backlog: handoffs parked in a prefill replica's
        #     outbox are finished prefills the decode pool could not absorb
        #     (it drained away or stalled) — more prefill routed here joins
        #     a pipeline that is not moving, so each parked handoff charges
        #     the decode admission *its own* KV context is waiting on.
        #     Empty outbox (the steady state, and every unified fleet) ⇒ 0.0.
        stalled = sum(cost.decode_step_time(1, h.kv_tokens)
                      for h in replica.outbox)

        delay = (ahead + contention) / max(replica.speed, 1e-6) + resid \
            + decode_drag + stalled
        # 4) KV pressure penalty: a nearly-full pool means admission stalls
        #    and preemption churn.
        occ = replica.kv_occupancy()
        if occ > self.kv_pressure_knee:
            delay *= 1.0 + self.kv_pressure_slope * (occ - self.kv_pressure_knee)
            delay += occ * 1e-3
        # 5) Fleet-consistency: prefer replicas whose installed partition
        #    agrees with the global policy map (no-op without a store).
        if self.policy_store is not None:
            delay *= self._alignment_factor(replica, snap)
        # 6) KV plane: the request's own (suffix-only) prefill cost + any
        #    planned remote-fetch exposure — the replica-dependent term
        #    that steers toward prefix holders (0.0 when inactive).
        if self._stash_terms:
            self._terms_by_rep[replica.replica_id] = (
                ahead, contention, resid, decode_drag, stalled, occ, own,
                delay + own)
        return delay + own


def make_router(name: str, cost: CostModel | None = None, **kw) -> Router:
    """Router factory by short name: round_robin / least_loaded / ewsjf."""
    if name in ("rr", "round_robin"):
        return RoundRobinRouter()
    if name in ("ll", "least_loaded"):
        return LeastLoadedRouter()
    if name == "ewsjf":
        return EWSJFRouter(cost=cost, **kw)
    raise ValueError(f"unknown router '{name}'; "
                     f"have round_robin, least_loaded, ewsjf")
