"""ReplicaModel — one serving replica of the cluster data plane.

A replica wraps a per-replica ``BaseScheduler`` (any core policy: FCFS /
SJF / EWSJF) plus cost-model-driven executor state: paged-KV occupancy,
the in-flight decode batch, a speed multiplier (heterogeneous hardware /
stragglers) and health flags.  ``step(now)`` runs one engine tick with the
same step-cost machinery as ``core/simulator.py`` (chunked prefill charge,
multi-step decode charge, LIFO recompute preemption), so a cluster of
replicas is benchmarkable on CPU in "simulator units".

Paged-KV accounting runs on the serving layer's
:class:`~repro_torch.serving.kv_cache.BlockPool` (one pool per replica).  With
``ReplicaParams.enable_prefix_cache`` the replica additionally owns a
:class:`~repro_torch.kvplane.radix.RadixPrefixIndex` as a *second tenant of the
same pool*: dispatched requests match their ``prompt_hashes`` against it,
prefill is charged only for the uncached suffix
(``CostModel.prefill_cost``), matched paths are pinned for the request's
lifetime, and freshly computed blocks are inserted back.  Remote prefix
fetches planned by a prefix-aware router (``Request.prefix_fetch``) are
charged against the shared :class:`~repro_torch.kvplane.topology.LinkTopology`
with compute overlap.  With the cache disabled every code path degrades to
the pre-KV-plane integer arithmetic bit-for-bit.

Roles (disaggregated prefill/decode, DistServe-style):

  * ``unified``  — prefill + decode on the same replica (default);
  * ``prefill``  — prefill only; completed prefills are emitted as
    ``KVHandoff``s (see cluster/disagg.py) for a decode replica, with the
    KV bytes accounted against the interconnect;
  * ``decode``   — no local admission; accepts handoffs into its decode
    batch.  KV-pressure preemptions are *evictions*: recompute requires a
    prefill replica, so victims go back to the cluster router.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from ..core.batch_builder import BatchBudget
from ..core.cost_model import CostModel
from ..core.scheduler import BaseScheduler, FCFSScheduler
from ..core.types import Request, RequestState, SchedulerSnapshot, TerminalState
from ..kvplane.radix import RadixPrefixIndex
from ..serving.kv_cache import BlockPool
from .disagg import KVHandoff


@dataclass
class ReplicaParams:
    """Executor sizing: decode slots, prefill budget, paged-KV pool, and
    the optional prefix-cache tenancy knobs."""
    max_num_seqs: int = 64              # decode slots
    max_prefill_tokens: int = 8192      # chunked-prefill budget per tick
    kv_pool_tokens: int = 131072        # paged-KV pool capacity
    block_size: int = 16
    decode_steps_per_tick: int = 8
    bucket_pad: bool = False
    scheduler_overhead: float = 50e-6
    # ---- KV plane (prefix reuse) ----
    enable_prefix_cache: bool = False
    prefix_cache_blocks: Optional[int] = None   # cap; None = share the pool
    prefix_advertise_k: int = 64        # hot prefixes published per sync

    @property
    def total_blocks(self) -> int:
        """Paged-KV pool capacity in blocks."""
        return self.kv_pool_tokens // self.block_size


class _ObsHandles:
    """Per-replica pre-bound metric series: labels are resolved once when
    the obs handle is wired, so the per-tick recording below is one dict
    update or bisect (the overhead contract is ≤ 10% with everything on).
    Names and labels follow the taxonomy in docs/ARCHITECTURE.md."""

    __slots__ = ("queue_depth", "dispatch_wait", "dispatch_score",
                 "prefill_seconds", "suffix_tokens", "cached_tokens",
                 "kv_occ", "preempt", "score_tick")

    def __init__(self, metrics, replica_id: int, preempt_kind: str):
        rep = {"replica": replica_id}
        self.queue_depth = metrics.gauge("sched_queue_depth", rep)
        self.dispatch_wait: dict = {}        # slo_class -> LogHistogram
        self.dispatch_score = metrics.hist("sched_dispatch_score")
        self.score_tick = 0                  # head-score peek sampler
        self.prefill_seconds = metrics.hist("prefill_batch_seconds", rep)
        self.suffix_tokens = metrics.counter(
            "prefill_tokens_total", {"kind": "suffix", "replica": replica_id})
        self.cached_tokens = metrics.counter(
            "prefill_tokens_total", {"kind": "cached", "replica": replica_id})
        self.kv_occ = metrics.gauge("kv_occupancy", rep)
        self.preempt = metrics.counter(
            "preemptions_total", {"replica": replica_id, "kind": preempt_kind})


@dataclass
class _Running:
    req: Request
    kv_tokens: int
    remaining: int
    pin_node: object = None             # radix node pinned for this request


class ReplicaModel:
    """One replica: scheduler + simulated executor + health state."""

    def __init__(self, replica_id: int, cost: CostModel,
                 scheduler: Optional[BaseScheduler] = None,
                 params: ReplicaParams | None = None,
                 role: str = "unified", speed: float = 1.0,
                 drop_fn: Optional[Callable[[Request, float], bool]] = None):
        assert role in ("unified", "prefill", "decode"), role
        self.replica_id = replica_id
        self.cost = cost
        self.sched = scheduler if scheduler is not None else FCFSScheduler()
        self.p = params or ReplicaParams()
        self.role = role
        self.speed = speed
        # Deadline-drop hook from the admission layer: applied at dispatch
        # time, the last point where dropping still saves the prefill.
        self.drop_fn = drop_fn

        # executor state
        self.running: list[_Running] = []
        self.pool = BlockPool(self.p.total_blocks, self.p.block_size)
        self.radix: Optional[RadixPrefixIndex] = (
            RadixPrefixIndex(self.pool, self.p.block_size,
                             capacity_blocks=self.p.prefix_cache_blocks)
            if self.p.enable_prefix_cache else None)
        self.topology = None                 # shared LinkTopology (simulator)
        self.peer_alive_fn: Optional[Callable[[int], bool]] = None
        # ^ liveness oracle for remote-prefix fetches (simulator-wired): a
        #   fetch plan stamped before the source replica failed must not
        #   materialize KV that died with the machine.
        self.busy_until = 0.0
        self.inbox: list[KVHandoff] = []     # decode: pending KV handoffs
        self.outbox: list[KVHandoff] = []    # prefill: completed prefills
        self.evicted: list[Request] = []     # decode: preemptions → re-route
        self.finished: list[Request] = []
        self.dropped: list[Request] = []     # deadline-dropped at dispatch

        # health / telemetry
        self.alive = True
        self.draining = False
        self.last_heartbeat = 0.0
        self.step_ewma = 0.0
        self.ewma_obs = 0            # observations feeding step_ewma
        self.served = 0
        self.preemptions = 0
        self.ticks = 0
        self.busy_time = 0.0
        self.tokens_out = 0          # cumulative generated tokens (throughput
                                     # telemetry for the health monitor EWMA)
        self.tokens_in = 0           # cumulative prefill suffix tokens — the
                                     # capacity signal for a *prefill*-role
                                     # replica, whose tokens_out stays ~0
                                     # because handoffs finish downstream
        self.tbt_ewma = 0.0          # smoothed inter-token delay (decode-side
                                     # burn signal for the autoscaler)
        # Lifetime stamps for replica-seconds accounting (cost of capacity):
        # ``born`` is set by ClusterSimulator.add_replica for scale-ups;
        # ``died`` is stamped when the replica leaves the fleet (fail / drain
        # completion).  None = still alive at end of run.
        self.born = 0.0
        self.died: Optional[float] = None
        self.prefix_saved_tokens = 0          # prefill tokens skipped via cache
        self.kv_ewma = 0.0           # smoothed occupancy (health monitor)
        # Queue-delay observations (arrival→prefill-dispatch wait) consumed
        # by the control plane (health monitor → SLO-burn autoscaler).
        # Bounded: stale samples age out if nobody drains them.
        self.dispatch_log: deque = deque(maxlen=512)
        # Observability handle (obs.Observability), wired by the cluster
        # simulator.  Every emission site below is guarded on None so the
        # disabled path is zero-cost and decisions stay bit-identical.
        # Assigning builds per-replica metric handles (labels resolved
        # once) so per-tick recording stays within the overhead contract.
        self._obs = None
        self._obsh: Optional[_ObsHandles] = None
        # Output-length predictor (repro_torch.predict), wired by the cluster
        # simulator.  Used for preemption-victim selection and predicted
        # decode-drag costing; fed true output lengths at finish.  Every
        # consumer falls back to the length-blind arithmetic when the
        # predictor is absent or abstained on the requests involved, so
        # predictor=None stays bit-identical.
        self.predictor = None

    # ---- observability wiring --------------------------------------------

    @property
    def obs(self):
        """Observability handle (None = disabled, zero-cost path)."""
        return self._obs

    @obs.setter
    def obs(self, value) -> None:
        self._obs = value
        self._obsh = None
        if value is not None and value.metrics is not None:
            kind = "evict" if self.role == "decode" else "preempt"
            self._obsh = _ObsHandles(value.metrics, self.replica_id, kind)

    # ---- routing-facing introspection -----------------------------------

    @property
    def pod_id(self) -> int:
        """Legacy alias for ``replica_id`` (distributed API)."""
        return self.replica_id

    @property
    def free_blocks(self) -> int:
        """Unallocated blocks in the paged-KV pool."""
        return self.pool.free_blocks

    def schedulable(self) -> bool:
        """Alive and not draining: a valid routing target."""
        return self.alive and not self.draining

    def accepts_prefill(self) -> bool:
        """Schedulable and prefill-capable (role unified or prefill)."""
        return self.schedulable() and self.role in ("unified", "prefill")

    def accepts_decode(self) -> bool:
        """Schedulable and decode-capable (role unified or decode)."""
        return self.schedulable() and self.role in ("unified", "decode")

    def kv_occupancy(self) -> float:
        """Instantaneous paged-KV pool utilization in [0, 1]."""
        return self.pool.utilization

    def inflight(self) -> int:
        """Size of the running decode batch."""
        return len(self.running)

    def prefix_probe(self, hashes) -> int:
        """Read-only longest-prefix match in *blocks* (router costing; no
        LRU touch, no counters).  0 without a cache or hashes."""
        if self.radix is None or not hashes:
            return 0
        return self.radix.match(hashes, touch=False).blocks

    def prefix_adverts(self) -> dict:
        """Hot cached prefixes for the fleet directory ({hash: depth})."""
        if self.radix is None:
            return {}
        return self.radix.hot_adverts(self.p.prefix_advertise_k)

    def scheduler_snapshot(self, now: float,
                           fresh: bool = False) -> SchedulerSnapshot:
        """Routing view of the local scheduler.  The default consumes the
        scheduler's incrementally-maintained snapshot (event-driven
        invalidation, O(queues) per access); ``fresh=True`` forces a full
        rebuild — the legacy per-arrival path, kept for verification and
        the control-plane overhead benchmark."""
        if fresh:
            return self.sched.snapshot(now)
        return self.sched.snapshot_cached(now)

    def exec_residual(self, now: float) -> float:
        """Seconds until the current engine step finishes."""
        return max(0.0, self.busy_until - now)

    def backlog_cost(self, now: float) -> float:
        """Coarse work estimate (seconds at this replica's speed): queued
        prefill + residual decode of the in-flight batch."""
        snap = self.sched.snapshot_cached(now)
        queued = sum(self.cost.c_prefill(q.mean_len) * q.depth
                     for q in snap.queues if q.depth)
        decode = sum(rr.remaining * self.cost.decode_step_time(1, rr.kv_tokens)
                     for rr in self.running)
        pend = sum(h.req.max_new_tokens
                   * self.cost.decode_step_time(1, h.kv_tokens)
                   for h in self.inbox)
        return (queued + decode + pend) / max(self.speed, 1e-6)

    def _predicted_batch(self) -> Optional[tuple[int, int, float]]:
        """(batch size, current KV tokens, predicted total remaining
        tokens) for the decode batch (running + inbox), using the wired
        predictor's remaining-work posterior for stamped requests and the
        ``max_new_tokens`` residual for unstamped ones.  None — consumers
        fall back to length-blind formulas — when no predictor is wired or
        no request in the batch carries a prediction stamp (abstain ≡
        off)."""
        if self.predictor is None:
            return None
        rems: list[float] = []
        kv = 0
        stamped = False
        for item in list(self.running) + list(self.inbox):
            kv += item.kv_tokens
            req = item.req
            if req.predicted_output is not None:
                stamped = True
                rems.append(self.predictor.remaining_work(req,
                                                          req.generated))
            else:
                rems.append(float(max(req.max_new_tokens
                                      - req.generated, 0)))
        if not stamped or not rems:
            return None
        return len(rems), kv, float(sum(rems))

    def predicted_decode_seconds(self) -> Optional[float]:
        """Predicted seconds to drain the decode batch (running + inbox),
        batch-amortized: total predicted remaining tokens divided by the
        batch size, times the decode step time at the batch's mid-drain KV
        footprint, at this replica's speed.  This is the *predicted
        KV-seconds* signal decode placement and admission charge.  None
        under ``_predicted_batch``'s abstain conditions."""
        pb = self._predicted_batch()
        if pb is None:
            return None
        b, kv, total = pb
        step = self.cost.decode_step_time(b, int(kv + total / 2.0))
        return (total / b) * step / max(self.speed, 1e-6)

    def predicted_step_seconds(self) -> Optional[float]:
        """Predicted per-step decode time (TBT) at the batch's mid-drain
        KV footprint, at this replica's speed.  The near-term interference
        signal: what one more decode step costs anything sharing this
        executor.  Same abstain conditions as
        ``predicted_decode_seconds``; unlike it, this does *not* scale
        with remaining tokens — prefill routing charges a bounded number
        of steps of drag, not the whole drain."""
        pb = self._predicted_batch()
        if pb is None:
            return None
        b, kv, total = pb
        step = self.cost.decode_step_time(b, int(kv + total / 2.0))
        return step / max(self.speed, 1e-6)

    def has_work(self) -> bool:
        """Anything running, queued, or pending in the handoff inbox."""
        return bool(self.running or self.inbox
                    or (self.role != "decode" and self.sched.waiting()))

    # ---- request path ----------------------------------------------------

    def submit(self, req: Request, now: float) -> None:
        """Enqueue a routed request into the local scheduler."""
        self.sched.submit(req, now)
        obs = self._obs
        if obs is not None:
            if obs.trace is not None:
                obs.trace.emit("enqueue", now, req.request_id,
                               self.replica_id)

    def accept_handoff(self, handoff: KVHandoff, now: float) -> None:
        """Receive a KV handoff (decode admission happens at the next tick)."""
        self.inbox.append(handoff)

    # ---- failure / drain --------------------------------------------------

    def fail(self) -> list[Request]:
        """Hard failure: everything in flight or queued is lost locally and
        returned for global re-enqueue (recompute recovery, no KV rescue).
        The prefix cache dies with the machine."""
        self.alive = False
        orphans: list[Request] = []
        for rr in self.running:
            orphans.append(rr.req)
        orphans.extend(h.req for h in self.inbox)
        # un-shipped handoffs die with the machine holding their KV
        orphans.extend(h.req for h in self.outbox)
        orphans.extend(self.sched.drain())
        self.running = []
        self.inbox = []
        self.outbox = []
        self.pool = BlockPool(self.p.total_blocks, self.p.block_size)
        self.radix = (RadixPrefixIndex(self.pool, self.p.block_size,
                                       capacity_blocks=self.p.prefix_cache_blocks)
                      if self.p.enable_prefix_cache else None)
        for req in orphans:
            req.state = RequestState.PREEMPTED
            req.preemptions += 1
            req.generated = 0
            req.first_token_time = None
            req.cached_len = 0           # its cached prefix is gone too
            req.prefix_fetch = None
        return orphans

    def start_drain(self) -> list[Request]:
        """Graceful drain (straggler mitigation): stop accepting, finish
        in-flight work, give queued work back for re-routing."""
        self.draining = True
        queued = self.sched.drain()
        for req in queued:
            req.state = RequestState.WAITING
        if not self.has_work():
            self.alive = False
        return queued

    # ---- one engine tick ---------------------------------------------------

    def step(self, now: float) -> float:
        """Run one tick; returns the (speed-scaled) wall time consumed."""
        self.ticks += 1
        dt = self.p.scheduler_overhead

        if hasattr(self.sched, "maybe_reoptimize"):
            self.sched.maybe_reoptimize(now)

        dt += self._accept_handoffs(now)
        if self.role != "decode":
            dt += self._prefill_tick(now + dt)
        if self.role != "prefill":
            dt += self._decode_tick(now + dt)

        a = 0.2
        self.step_ewma = ((1 - a) * self.step_ewma + a * dt
                          if self.step_ewma else dt)
        self.ewma_obs += 1
        self.busy_time += dt
        self.last_heartbeat = now + dt
        if self.draining and not self.has_work():
            self.alive = False
            if self.died is None:
                self.died = now + dt
        return dt

    def _blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.p.block_size)

    def _accept_handoffs(self, now: float) -> float:
        still: list[KVHandoff] = []
        for h in self.inbox:
            if (h.ready_time > now
                    or len(self.running) >= self.p.max_num_seqs
                    or not self.pool.can_allocate(h.kv_tokens)):
                still.append(h)
                continue
            rem = max(h.req.max_new_tokens - h.req.generated, 0)
            if rem == 0:
                self._finish(h.req, now)
            else:
                self.pool.allocate(h.req.request_id, h.kv_tokens)
                self.running.append(_Running(h.req, h.kv_tokens, rem))
        self.inbox = still
        return 0.0           # handoff admission is free; transfer was charged
                             # by the channel

    # ---- KV plane: prefix attach at dispatch -----------------------------

    def _prefix_attach(self, r: Request, now: float
                       ) -> tuple[int, int, object, float]:
        """Authoritative prefix resolution for one dispatched request:
        match the local radix, execute any planned remote fetch (charged on
        the shared topology with compute overlap), insert + pin the
        request's full prefix path.  Returns ``(cached_tokens,
        prefix_blocks_resident, pin_node, exposed_transfer_s)`` — cached
        tokens are the prefill work actually *skipped* (local + fetched
        blocks, never the blocks computed this pass)."""
        if self.radix is None or not r.prompt_hashes:
            r.prefix_fetch = None
            return 0, 0, None, 0.0
        hashes = r.prompt_hashes
        m = self.radix.match(hashes, now)
        reused = m.blocks
        exposed = 0.0
        fetch = r.prefix_fetch
        r.prefix_fetch = None
        if (fetch is not None and self.topology is not None
                and fetch.blocks > m.blocks
                and (self.peer_alive_fn is None
                     or self.peer_alive_fn(fetch.src_replica))):
            # Fetch only the missing tail of the advertised prefix; blocks
            # that fail to land (pool pressure) were transferred in vain.
            want = min(int(fetch.blocks), len(hashes))
            missing = want - m.blocks
            n_bytes = (missing * self.p.block_size
                       * self.cost.model.kv_bytes_per_token)
            exposed = self.topology.fetch(n_bytes, fetch.src_replica,
                                          self.replica_id, now)
            node, _ = self.radix.insert(hashes[:want], now)
            reused = node.depth if node is not None else 0
            if self.obs is not None:
                link = f"{fetch.src_replica}->{self.replica_id}"
                self.obs.event("prefix_fetch", now,
                               request_id=r.request_id,
                               replica_id=self.replica_id,
                               data={"src": fetch.src_replica,
                                     "bytes": int(n_bytes),
                                     "exposed_s": round(exposed, 6)})
                self.obs.inc("kv_fetch_bytes_total", {"link": link},
                             float(n_bytes))
                self.obs.observe("kv_fetch_exposed_seconds", exposed,
                                 {"link": link})
        # Cache the blocks computed this pass too (they are about to exist).
        full_blocks = int(r.prompt_len) // self.p.block_size
        pin_node, _ = self.radix.insert(hashes[:full_blocks], now)
        self.radix.pin(pin_node)
        resident = pin_node.depth if pin_node is not None else 0
        cached_tokens = min(reused * self.p.block_size,
                            int(r.prompt_len) - 1)
        r.cached_len = cached_tokens
        self.prefix_saved_tokens += cached_tokens
        return cached_tokens, resident, pin_node, exposed

    def _release(self, rr: _Running) -> None:
        """Free a running request's private blocks and unpin its prefix."""
        self.pool.free(rr.req.request_id)
        if self.radix is not None and rr.pin_node is not None:
            self.radix.unpin(rr.pin_node)

    def _prefill_tick(self, now: float) -> float:
        slots = self.p.max_num_seqs - len(self.running)
        if slots <= 0:
            return 0.0
        depth = self.sched.waiting()
        if self._obsh is not None:
            # Gauge the backlog here, where waiting() is already computed
            # for the dispatch decision, instead of per-submit.
            self._obsh.queue_depth.set(float(depth))
        if depth == 0:
            return 0.0
        budget = BatchBudget(max_requests=slots,
                             max_tokens=self.p.max_prefill_tokens,
                             kv_blocks_free=self.free_blocks,
                             block_size=self.p.block_size,
                             pad_mode=self.p.bucket_pad)
        head_scores = None
        if self._obsh is not None:
            # Read-only peek at the pre-dispatch head scores: a dispatched
            # request was (approximately) the head of its queue, so its
            # density-weighted score at dispatch is that queue's head score.
            # The peek costs a snapshot delta, so it is *sampled* (every
            # 4th dispatch round) and skipped entirely in trace-only runs;
            # the dispatch-score histogram is statistical either way.
            self._obsh.score_tick += 1
            if self._obsh.score_tick % 4 == 1:
                snap0 = self.sched.snapshot_cached(now)
                head_scores = {q.queue_id: q.head_score
                               for q in snap0.queues}
        plan = self.sched.tick(now, budget)
        if self.drop_fn is not None and plan.requests:
            live = []
            for r in plan.requests:
                if self.drop_fn(r, now):
                    r.state = RequestState.FAILED
                    r.finish_time = now
                    r.terminal = TerminalState.DEADLINE_DROPPED
                    self.dropped.append(r)
                    if self.obs is not None:
                        cls = self.obs.slo_class(r)
                        self.obs.event("deadline_drop", now,
                                       request_id=r.request_id,
                                       replica_id=self.replica_id,
                                       data={"slo_class": cls})
                        self.obs.inc(
                            "requests_terminal_total",
                            {"state": TerminalState.DEADLINE_DROPPED.value,
                             "slo_class": cls})
                else:
                    live.append(r)
            plan.requests = live
            plan.total_tokens = sum(int(r.effective_len) for r in live)
        if not plan.requests:
            return 0.0
        obs, obsh = self._obs, self._obsh
        for r in plan.requests:
            wait = max(0.0, now - r.arrival_time)
            self.dispatch_log.append((r, wait))
            if obs is not None:
                if obs.trace is not None:
                    obs.trace.emit("dispatch", now, r.request_id,
                                   self.replica_id, 0.0, {"wait": wait})
                if obsh is not None:
                    cls = r.slo_class
                    if cls is None:
                        cls = obs.slo_class(r)
                    h = obsh.dispatch_wait.get(cls)
                    if h is None:
                        h = obsh.dispatch_wait[cls] = obs.metrics.hist(
                            "sched_dispatch_wait_seconds",
                            {"slo_class": cls})
                    h.observe(wait)
                    if head_scores and r.queue_id in head_scores:
                        obsh.dispatch_score.observe(head_scores[r.queue_id])
        # Authoritative prefix resolution (the router's cached_len was an
        # estimate; the radix decides what is actually reusable now).
        attach = [self._prefix_attach(r, now) for r in plan.requests]
        suffix_tokens = sum(int(r.prompt_len) - a[0]
                            for r, a in zip(plan.requests, attach))
        exposed_fetch = sum(a[3] for a in attach)
        padded = max(plan.padded_tokens if self.p.bucket_pad else suffix_tokens,
                     suffix_tokens)
        # Attention context is the *full* context (cached prefix included);
        # only the dense/suffix charge shrinks with reuse.
        mean_ctx = (sum(int(r.prompt_len) for r in plan.requests)
                    / len(plan.requests))
        self.tokens_in += suffix_tokens
        dt = (self.cost.prefill_step_time(padded, mean_ctx) + exposed_fetch) \
            / max(self.speed, 1e-6)
        end = now + dt
        if obs is not None:
            cached_total = sum(a[0] for a in attach)
            if obs.trace is not None:
                obs.trace.emit("prefill", now, -1, self.replica_id, dt,
                               {"batch": len(plan.requests),
                                "suffix_tokens": suffix_tokens,
                                "cached_tokens": cached_total})
                for r in plan.requests:
                    obs.trace.emit("first_token", end, r.request_id,
                                   self.replica_id)
            if obsh is not None:
                obsh.prefill_seconds.observe(dt)
                obsh.suffix_tokens.inc(float(suffix_tokens))
                if cached_total:
                    obsh.cached_tokens.inc(float(cached_total))
        for r, (cached, resident, pin_node, _) in zip(plan.requests, attach):
            r.state = RequestState.RUNNING_DECODE
            r.first_token_time = end
            r.generated = 1
            kv = int(r.prompt_len) + 1
            rem = max(r.max_new_tokens - 1, 0)
            if self.role == "prefill":
                # Disaggregation: the KV moves to a decode replica.  The
                # prefix path stays cached here but is not pinned past the
                # handoff (the running sequence leaves this machine).
                if self.radix is not None and pin_node is not None:
                    self.radix.unpin(pin_node)
                self.served += 1
                if rem == 0:
                    self._finish(r, end)
                else:
                    self.outbox.append(KVHandoff(
                        req=r, kv_tokens=kv, src_replica=self.replica_id,
                        kv_bytes=kv * self.cost.model.kv_bytes_per_token))
            elif rem == 0:
                if self.radix is not None and pin_node is not None:
                    self.radix.unpin(pin_node)
                self._finish(r, end)
            else:
                private = kv - resident * self.p.block_size
                self.pool.allocate_unchecked(r.request_id, private)
                self.running.append(_Running(r, kv, rem, pin_node=pin_node))
        return dt

    def _victim_index(self) -> int:
        """Index into ``self.running`` of the preemption victim: the
        stamped request with the largest predicted remaining work (ties →
        the later arrival, preserving the LIFO flavor).  −1 (the LIFO
        victim) when no predictor is wired or nothing is stamped."""
        if self.predictor is None:
            return -1
        best, besti, found = -1.0, -1, False
        for i, rr in enumerate(self.running):
            if rr.req.predicted_output is None:
                continue
            found = True
            rem = self.predictor.remaining_work(rr.req, rr.req.generated)
            if rem >= best:
                best, besti = rem, i
        return besti if found else -1

    def _decode_tick(self, now: float) -> float:
        dt = 0.0
        steps = 0
        for _ in range(self.p.decode_steps_per_tick):
            if not self.running:
                break
            steps += 1
            need = sum(1 for rr in self.running
                       if (rr.kv_tokens % self.p.block_size) == 0)
            while need > self.free_blocks and len(self.running) > 1:
                # Victim selection: with prediction stamps, demote the
                # request with the largest expected *remaining* work
                # (Gittins-style — it holds KV longest for the least
                # near-term completion); otherwise LIFO recompute.
                victim = self.running.pop(self._victim_index())
                self._release(victim)
                victim.req.state = RequestState.PREEMPTED
                victim.req.preemptions += 1
                victim.req.generated = 0
                victim.req.first_token_time = None
                self.preemptions += 1
                if self._obs is not None:
                    if self._obs.trace is not None:
                        kind = ("evict" if self.role == "decode"
                                else "preempt")
                        self._obs.trace.emit(
                            kind, now + dt,
                            request_id=victim.req.request_id,
                            replica_id=self.replica_id)
                    if self._obsh is not None:
                        self._obsh.preempt.inc()
                if self.role == "decode":
                    self.evicted.append(victim.req)  # needs a prefill replica
                else:
                    self.sched.submit(victim.req, now + dt)
                need = sum(1 for rr in self.running
                           if (rr.kv_tokens % self.p.block_size) == 0)
            total_kv = sum(rr.kv_tokens for rr in self.running)
            step = self.cost.decode_step_time(len(self.running),
                                              total_kv) / max(self.speed, 1e-6)
            dt += step
            # Inter-token delay: one decode step emits one token for every
            # running sequence, so ``step`` *is* the batch's TBT this round.
            a = 0.2
            self.tbt_ewma = ((1 - a) * self.tbt_ewma + a * step
                             if self.tbt_ewma else step)
            done = []
            for i, rr in enumerate(self.running):
                if rr.kv_tokens % self.p.block_size == 0:
                    self.pool.allocate_unchecked(rr.req.request_id,
                                                 self.p.block_size)
                rr.kv_tokens += 1
                rr.req.generated += 1
                rr.remaining -= 1
                if rr.remaining <= 0:
                    done.append(i)
            for i in reversed(done):
                rr = self.running.pop(i)
                self._release(rr)
                self._finish(rr.req, now + dt)
        if self._obs is not None and dt > 0.0:
            if self._obs.trace is not None:
                self._obs.trace.emit("decode", now, -1, self.replica_id, dt,
                                     {"batch": len(self.running),
                                      "steps": steps})
            if self._obsh is not None:
                self._obsh.kv_occ.set(self.pool.utilization)
        return dt

    def _finish(self, req: Request, t: float) -> None:
        req.state = RequestState.FINISHED
        req.finish_time = t
        req.terminal = TerminalState.FINISHED
        self.finished.append(req)
        self.tokens_out += req.generated
        if self.role != "prefill":
            self.served += 1
        self.sched.on_finish(req, t)
        if self.predictor is not None:
            self.predictor.observe(req, t)
        if self._obs is not None:
            self._obs.finish(req, t, self.replica_id)
