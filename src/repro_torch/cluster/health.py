"""Heartbeat-based health monitoring shared by the cluster simulator and
the legacy ``distributed.ClusterController``: dead-replica detection via
heartbeat timeout, straggler detection via step-latency EWMA vs the
cluster median.

The monitor is also the control plane's telemetry tap: ``delay_samples``
drains each replica's dispatch log (arrival→prefill wait of every request
that started) and samples the current queue heads' waits, feeding the
SLO-burn autoscaler (see cluster/autoscaler.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np

from .replica import ReplicaModel


@dataclass
class HealthConfig:
    """Detection thresholds + telemetry smoothing factors."""
    heartbeat_timeout: float = 5.0
    straggler_factor: float = 3.0
    check_interval: float = 1.0
    throughput_alpha: float = 0.3    # fleet token-rate EWMA smoothing
    kv_alpha: float = 0.3            # KV-occupancy EWMA smoothing


class HealthMonitor:
    """Heartbeat/straggler detector and the control plane's telemetry tap
    (throughput, KV occupancy, queue-delay and decode-pressure samples)."""
    def __init__(self, cfg: HealthConfig | None = None):
        self.cfg = cfg or HealthConfig()
        self.failures: list[int] = []
        self.stragglers: list[int] = []
        self._last_check = 0.0
        # Measured fleet throughput (tokens/s EWMA over check intervals):
        # feeds the admission layer's adaptive token-bucket refill.  The
        # per-replica EWMAs additionally drive the admission layer's
        # *per-replica budget shares* (each replica's slice of the fleet
        # refill is proportional to its measured output rate).
        self.tok_rate_ewma = 0.0
        self.replica_rate: dict[int, float] = {}
        # Per-replica *prefill*-token rate EWMAs (``tokens_in``): the
        # capacity signal for prefill-role replicas in a disaggregated
        # fleet, whose ``tokens_out`` stays ~0 because their handoffs
        # finish on a decode replica.  Feeds the role-aware admission
        # budget-share split (see ClusterSimulator._admission_share_rates).
        self.replica_prefill_rate: dict[int, float] = {}
        self._tok_seen = 0
        self._rep_seen: dict[int, int] = {}
        self._rep_in_seen: dict[int, int] = {}
        self._tok_t: float | None = None
        # Smoothed per-replica KV occupancy (+ high-water mark): surfaced
        # to the router via ``ReplicaModel.kv_ewma`` so prefix-aware
        # routing avoids fetching prefixes into nearly-exhausted pools.
        self.kv_ewma: dict[int, float] = {}
        self.kv_peak: dict[int, float] = {}
        # Real-engine heartbeats (``ServingEngine.heartbeat()`` beacons):
        # last-seen clock + last full beacon per engine_id.  Engines fold
        # into the same kv_ewma/kv_peak maps as DES replicas so routing
        # and reporting read one occupancy view across backends.
        self.engine_seen: dict[int, float] = {}
        self.engine_beacon: dict[int, dict] = {}

    def due(self, now: float) -> bool:
        """Whether a check interval elapsed since the last health round."""
        return now - self._last_check >= self.cfg.check_interval

    def observe_throughput(self, replicas: Iterable[ReplicaModel],
                           now: float) -> float:
        """Fold the fleet's cumulative generated-token counters into the
        token-rate EWMA (fleet total + per replica).  Call once per check
        round (the cluster simulator does); returns the fleet EWMA."""
        replicas = list(replicas)
        total = sum(r.tokens_out for r in replicas)
        if self._tok_t is None:
            self._tok_seen, self._tok_t = total, now
            self._rep_seen = {r.replica_id: r.tokens_out for r in replicas}
            self._rep_in_seen = {r.replica_id: r.tokens_in for r in replicas}
            return self.tok_rate_ewma
        dt = now - self._tok_t
        if dt <= 0:
            return self.tok_rate_ewma
        rate = (total - self._tok_seen) / dt
        a = self.cfg.throughput_alpha
        self.tok_rate_ewma = (rate if self.tok_rate_ewma <= 0
                              else (1 - a) * self.tok_rate_ewma + a * rate)
        live = set()
        for r in replicas:
            if not r.alive:
                continue            # dead replicas must not keep a rate (or
                                    # a budget share) — drop below
            live.add(r.replica_id)
            rr = (r.tokens_out - self._rep_seen.get(r.replica_id, 0)) / dt
            prev = self.replica_rate.get(r.replica_id, 0.0)
            self.replica_rate[r.replica_id] = (rr if prev <= 0
                                               else (1 - a) * prev + a * rr)
            self._rep_seen[r.replica_id] = r.tokens_out
            ri = (r.tokens_in - self._rep_in_seen.get(r.replica_id, 0)) / dt
            prev_in = self.replica_prefill_rate.get(r.replica_id, 0.0)
            self.replica_prefill_rate[r.replica_id] = (
                ri if prev_in <= 0 else (1 - a) * prev_in + a * ri)
            self._rep_in_seen[r.replica_id] = r.tokens_in
        for rid in list(self.replica_rate):
            if rid not in live:
                self.replica_rate.pop(rid, None)
                self._rep_seen.pop(rid, None)
                self.replica_prefill_rate.pop(rid, None)
                self._rep_in_seen.pop(rid, None)
        self._tok_seen, self._tok_t = total, now
        return self.tok_rate_ewma

    def observe_kv(self, replicas: Iterable[ReplicaModel]) -> dict:
        """Fold each replica's instantaneous KV-pool occupancy into a
        smoothed per-replica EWMA (written back onto the replica as
        ``kv_ewma`` for the router's snapshot-time reads) and track the
        high-water mark.  Returns the EWMA map."""
        a = self.cfg.kv_alpha
        live = set()
        for r in replicas:
            if not r.alive:
                continue
            live.add(r.replica_id)
            occ = r.kv_occupancy()
            prev = self.kv_ewma.get(r.replica_id)
            cur = occ if prev is None else (1 - a) * prev + a * occ
            self.kv_ewma[r.replica_id] = cur
            r.kv_ewma = cur
            self.kv_peak[r.replica_id] = max(
                self.kv_peak.get(r.replica_id, 0.0), occ)
        for rid in list(self.kv_ewma):
            if rid not in live:
                self.kv_ewma.pop(rid, None)
        return self.kv_ewma

    def observe_engine_heartbeat(self, hb: dict,
                                 now: float | None = None) -> None:
        """Fold one real-engine heartbeat (``ServingEngine.heartbeat()``)
        into the monitor: records liveness (``engine_alive``) and folds the
        beacon's KV occupancy into the same ``kv_ewma``/``kv_peak`` maps
        the DES replicas use, under the engine's ``engine_id`` — one
        occupancy view across both backends.  ``now`` defaults to the
        beacon's own clock (engines report monotonic seconds since
        construction)."""
        eid = int(hb["engine_id"])
        t = float(hb["t"] if now is None else now)
        self.engine_seen[eid] = t
        self.engine_beacon[eid] = hb
        occ = float(hb.get("kv_occupancy", 0.0))
        a = self.cfg.kv_alpha
        prev = self.kv_ewma.get(eid)
        self.kv_ewma[eid] = occ if prev is None else (1 - a) * prev + a * occ
        self.kv_peak[eid] = max(self.kv_peak.get(eid, 0.0), occ)

    def engine_alive(self, engine_id: int, now: float) -> bool:
        """Heartbeat-timeout liveness for a real engine: True iff a beacon
        arrived within ``heartbeat_timeout`` of ``now`` (unknown engines
        are dead — they never reported)."""
        seen = self.engine_seen.get(engine_id)
        return (seen is not None
                and now - seen <= self.cfg.heartbeat_timeout)

    def kv_stats(self) -> dict:
        """Smoothed + peak per-replica KV occupancy (for result reporting)."""
        return {"ewma": dict(self.kv_ewma), "peak": dict(self.kv_peak)}

    def check(self, replicas: Iterable[ReplicaModel], now: float
              ) -> tuple[list[ReplicaModel], list[ReplicaModel]]:
        """Returns (dead, stragglers-to-drain).  The caller owns the
        consequences (re-enqueue / drain) so recovery policy stays with the
        data plane, not the detector."""
        self._last_check = now
        alive = [r for r in replicas if r.alive]
        dead = [r for r in alive
                if now - r.last_heartbeat > self.cfg.heartbeat_timeout
                and r.has_work()]
        drain: list[ReplicaModel] = []
        # Straggler detection compares within a role only: a prefill
        # replica's step is legitimately orders of magnitude longer than a
        # decode replica's, so a cross-role median would flag the whole
        # prefill pool.
        for role in {r.role for r in alive}:
            peers = [r for r in alive if r.role == role]
            ewmas = [r.step_ewma for r in peers if r.step_ewma > 0]
            if len(ewmas) < 2:
                continue
            med = float(np.median(ewmas))
            drain.extend(r for r in peers
                         if (not r.draining and r.ewma_obs >= 3
                             and r.step_ewma
                             > self.cfg.straggler_factor * med
                             and r not in dead))
        self.failures.extend(r.replica_id for r in dead)
        self.stragglers.extend(r.replica_id for r in drain)
        return dead, drain

    def delay_samples(self, replicas: Iterable[ReplicaModel], now: float
                      ) -> list[tuple[float, int, float]]:
        """Queue-delay observations as ``(prompt_len, priority_class,
        wait)`` triples: dispatched requests (drained from each replica's
        bounded dispatch log) plus the *current* head-of-line waits — the
        latter keep the burn signal rising while a saturated replica is
        stuck between dispatches."""
        samples: list[tuple[float, int, float]] = []
        for rep in replicas:
            if not rep.alive:
                rep.dispatch_log.clear()
                continue
            while rep.dispatch_log:
                req, wait = rep.dispatch_log.popleft()
                samples.append((float(req.prompt_len), req.priority_class,
                                wait))
            if rep.accepts_prefill():
                snap = rep.scheduler_snapshot(now)
                for q in snap.queues:
                    if q.depth and q.head_len is not None:
                        samples.append((q.head_len, 0, q.head_wait))
        return samples

    def decode_samples(self, replicas: Iterable[ReplicaModel]
                       ) -> list[tuple[float, float, float]]:
        """Decode-side pressure observations as ``(tbt_ewma, kv_occupancy,
        inbox_ratio)`` triples, one per live decode-capable replica.  The
        triple captures the three ways a decode pool saturates: inter-token
        delay rising (batch/KV-bound step time), the smoothed KV-pool
        occupancy approaching exhaustion (eviction churn imminent), and
        handoffs queueing in the inbox faster than slots free up.  Feeds
        the role-aware autoscaler's decode burn signal
        (``SLOBurnAutoscaler.ingest_decode``)."""
        samples: list[tuple[float, float, float]] = []
        for rep in replicas:
            if not rep.alive or not rep.accepts_decode():
                continue
            occ = self.kv_ewma.get(rep.replica_id, rep.kv_occupancy())
            inbox_ratio = len(rep.inbox) / max(rep.p.max_num_seqs, 1)
            # tbt_ewma only updates while decode steps run, so an idle
            # batch would report its burst-time peak forever; no running
            # sequences ⇒ no inter-token pressure, by definition.
            tbt = rep.tbt_ewma if rep.inflight() else 0.0
            samples.append((tbt, occ, inbox_ratio))
        return samples
