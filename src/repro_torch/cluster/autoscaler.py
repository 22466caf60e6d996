"""Reactive autoscaling from SLO burn rate — homogeneous or role-aware.

The paper's thesis is that the scheduling layer should adapt from live
performance feedback; this module extends that loop to *fleet size*.  Each
SLO class tracks a **burn rate** — an EWMA of ``observed queue delay /
class TTFT budget`` fed by the health monitor's delay samples (dispatch
waits + current head-of-line waits).  Burn ≈ 1.0 means the class is
spending its whole TTFT budget queueing; sustained burn above the
scale-up threshold adds a replica, sustained burn below the scale-down
threshold drains one.  Hysteresis comes from three mechanisms:

  * a band between ``scale_up_burn`` and ``scale_down_burn`` where the
    autoscaler holds;
  * consecutive-breach *patience* counters (a single bursty sample never
    scales);
  * per-direction cooldowns so a fresh replica gets to absorb load before
    the controller reacts again.

**Role-aware mode** (``AutoscalerConfig.pools``): disaggregated prefill
and decode pools saturate on different resources — prefill is
compute-bound (TTFT burn: queue delay vs budget), decode is KV/batch-bound
(TBT burn: inter-token delay, KV-pool occupancy, handoff backlog) — so
one shared signal either over-scales the cheap pool or under-scales the
starved one.  With per-role :class:`RolePoolConfig`\\ s, each pool keeps
its own burn signal, patience counters, hold band, and cooldowns, and the
scaler makes independent per-role decisions under a fleet-total replica
budget clamp (most-pressured pool first when the budget can't fit every
scale-up).  The decode burn signal is fed by
``HealthMonitor.decode_samples`` (per-replica ``tbt_ewma``, smoothed KV
occupancy, inbox depth) via :meth:`SLOBurnAutoscaler.ingest_decode`.

The scaler only *decides*; the cluster simulator applies the decision
(``add_replica`` / graceful drain), mirroring how the health monitor
separates detection from recovery policy.  Scripted ``ScenarioEvent``
scale-ups remain available for fault injection, but steady-state elasticity
should come from here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.scheduler import BaseScheduler, FCFSScheduler
from ..core.types import Request
from .admission import DEFAULT_SLO_CLASSES, classify_by_length
from .replica import ReplicaModel


@dataclass
class RolePoolConfig:
    """Per-role scaling knobs for one pool of a disaggregated fleet.

    ``signal`` picks the burn source driving this pool: ``"prefill"``
    (per-SLO-class queue-delay burn — the TTFT side), ``"decode"``
    (TBT/KV/backlog pressure), or ``"max"`` (the max of both — the
    role-blind signal a homogeneous scaler reacts to).  The default ``""``
    resolves by role: prefill pools watch prefill burn, decode pools watch
    decode burn, unified pools watch both.
    """

    role: str = "unified"
    min_replicas: int = 1
    max_replicas: int = 8
    scale_up_burn: float = 1.0
    scale_down_burn: float = 0.30
    up_patience: int = 2
    down_patience: int = 8
    cooldown_up: float = 1.0
    cooldown_down: float = 5.0
    speed: float = 1.0               # speed of replicas added to this pool
    signal: str = ""                 # "" | "prefill" | "decode" | "max"

    def burn_signal(self) -> str:
        """Resolve the effective burn source for this pool."""
        if self.signal:
            return self.signal
        return {"prefill": "prefill", "decode": "decode"}.get(self.role,
                                                              "max")


@dataclass
class AutoscalerConfig:
    """Knobs for :class:`SLOBurnAutoscaler`.

    Without ``pools`` the scaler is the homogeneous single-pool controller
    (one role/speed, the flat fields below).  With ``pools`` set, the
    per-pool :class:`RolePoolConfig`\\ s take over sizing/hysteresis and
    the flat ``min/max_replicas``/patience/cooldown fields are ignored;
    ``fleet_max_replicas`` then clamps the *total* schedulable fleet size
    across pools (None = sum of the pool maxima).
    """

    min_replicas: int = 1
    max_replicas: int = 8
    check_interval: float = 0.25     # control-loop period (sim seconds)
    ewma_alpha: float = 0.35         # burn-rate smoothing
    scale_up_burn: float = 1.0       # burn above this (sustained) → add
    scale_down_burn: float = 0.30    # burn below this (sustained) → drain
    up_patience: int = 2             # consecutive breaches before acting
    down_patience: int = 8
    cooldown_up: float = 1.0         # seconds after any scale-up
    cooldown_down: float = 5.0       # seconds after any scale action
    role: str = "unified"            # role/speed of replicas we add
    speed: float = 1.0
    # ---- role-aware mode (disaggregated fleets) ----
    pools: Optional[tuple[RolePoolConfig, ...]] = None
    fleet_max_replicas: Optional[int] = None
    # Decode burn normalization: pressure 1.0 at any of these targets.
    tbt_budget: float = 0.05         # inter-token-delay budget (seconds)
    kv_target: float = 0.85          # KV occupancy treated as saturation
    inbox_target: float = 0.25       # queued handoffs per decode slot


@dataclass
class ScaleEvent:
    """One applied scale action (for ``stats()`` and the benchmarks)."""

    time: float
    action: str                      # "up" | "down"
    replica_id: int
    burn: dict[str, float] = field(default_factory=dict)
    role: str = "unified"


@dataclass
class _PoolState:
    """Per-pool hysteresis state (streaks + cooldown clocks)."""

    up_streak: int = 0
    down_streak: int = 0
    last_scale: float = float("-inf")
    last_up: float = float("-inf")


class SLOBurnAutoscaler:
    """Per-SLO-class (and per-role) burn tracking + scale decisions."""

    def __init__(self, scheduler_factory: Callable[[], BaseScheduler] = FCFSScheduler,
                 classes=DEFAULT_SLO_CLASSES,
                 classify: Optional[Callable[[Request], str]] = None,
                 cfg: AutoscalerConfig | None = None,
                 policy_store=None):
        self.scheduler_factory = scheduler_factory
        # Optional fleet PolicyStore: scale-up schedulers are warm-started
        # from the current global policy instead of defaults (the cluster
        # simulator wires its own store here when the caller didn't).
        self.policy_store = policy_store
        self.classes = {c.name: c for c in classes}
        self._classify = classify or classify_by_length
        self.cfg = cfg or AutoscalerConfig()
        self.burn: dict[str, float] = {c.name: 0.0 for c in classes}
        self.decode_burn = 0.0
        self.events: list[ScaleEvent] = []
        self._probe = Request(prompt_len=0)   # reusable classifier probe
        self._up_streak = 0
        self._down_streak = 0
        self._last_check = float("-inf")
        self._last_scale = float("-inf")
        self._last_up = float("-inf")
        self._pool_state: dict[str, _PoolState] = {}
        if self.cfg.pools is not None:
            roles = [p.role for p in self.cfg.pools]
            assert len(roles) == len(set(roles)), \
                f"duplicate pool roles in AutoscalerConfig.pools: {roles}"
            self._pool_state = {p.role: _PoolState() for p in self.cfg.pools}

    # ---- burn tracking ----------------------------------------------------

    @property
    def role_aware(self) -> bool:
        """Whether per-role pools are configured (disaggregated mode)."""
        return self.cfg.pools is not None

    def class_of(self, prompt_len: float, priority_class: int = 0) -> str:
        """SLO-class name a request of this shape would be admitted under."""
        self._probe.prompt_len = int(prompt_len)
        self._probe.priority_class = priority_class
        return self._classify(self._probe)

    def observe(self, class_name: str, delay: float) -> None:
        """Fold one queue-delay observation into a class's burn EWMA."""
        slo = self.classes[class_name]
        ratio = delay / max(slo.ttft_target, 1e-9)
        a = self.cfg.ewma_alpha
        self.burn[class_name] = (1 - a) * self.burn[class_name] + a * ratio

    def ingest(self, samples) -> None:
        """Fold health-monitor ``delay_samples`` into per-class burn.  A
        class with no sample this round observes 0 — an idle class should
        decay toward scale-down, not freeze at its burst-time burn."""
        seen: set[str] = set()
        for prompt_len, priority_class, wait in samples:
            name = self.class_of(prompt_len, priority_class)
            self.observe(name, wait)
            seen.add(name)
        for name in self.burn:
            if name not in seen:
                self.observe(name, 0.0)

    def ingest_decode(self, samples) -> float:
        """Fold health-monitor ``decode_samples`` — per-decode-replica
        ``(tbt_ewma, kv_occupancy, inbox_ratio)`` triples — into the
        decode-side burn EWMA.  Each replica's pressure is the max of its
        three normalized saturation ratios (inter-token delay vs the TBT
        budget, smoothed KV occupancy vs the target, queued handoffs per
        slot vs the target); the pool burn is the *mean* over replicas —
        pool capacity is what scaling changes, hotspots are the decode
        placement policy's problem.  No samples (no decode pool, or all
        idle) observes 0 so the signal decays like the prefill side."""
        if samples:
            pressures = []
            for tbt, occ, inbox_ratio in samples:
                pressures.append(max(
                    tbt / max(self.cfg.tbt_budget, 1e-9),
                    occ / max(self.cfg.kv_target, 1e-9),
                    inbox_ratio / max(self.cfg.inbox_target, 1e-9)))
            obs = sum(pressures) / len(pressures)
        else:
            obs = 0.0
        a = self.cfg.ewma_alpha
        self.decode_burn = (1 - a) * self.decode_burn + a * obs
        return self.decode_burn

    def peak_burn(self) -> float:
        """Highest per-SLO-class (prefill/TTFT-side) burn right now."""
        return max(self.burn.values()) if self.burn else 0.0

    def pool_burn(self, pool: RolePoolConfig) -> float:
        """The burn value driving one pool, per its resolved signal."""
        sig = pool.burn_signal()
        if sig == "prefill":
            return self.peak_burn()
        if sig == "decode":
            return self.decode_burn
        return max(self.peak_burn(), self.decode_burn)

    # ---- control loop -----------------------------------------------------

    def due(self, now: float) -> bool:
        """Whether a control-loop period elapsed since the last decision."""
        return now - self._last_check >= self.cfg.check_interval

    def decide(self, replicas: list[ReplicaModel], now: float) -> Optional[str]:
        """Homogeneous decision: "up", "down", or None.  Call after
        ``ingest``; the caller applies the action and then reports it via
        ``note_scaled``.  Role-aware fleets use :meth:`decide_roles`."""
        self._last_check = now
        n = sum(1 for r in replicas if r.schedulable())
        peak = self.peak_burn()
        if peak > self.cfg.scale_up_burn:
            self._up_streak += 1
            self._down_streak = 0
        elif peak < self.cfg.scale_down_burn:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0
        if (self._up_streak >= self.cfg.up_patience
                and n < self.cfg.max_replicas
                and now - self._last_up >= self.cfg.cooldown_up):
            return "up"
        if (self._down_streak >= self.cfg.down_patience
                and n > self.cfg.min_replicas
                and now - self._last_scale >= self.cfg.cooldown_down):
            return "down"
        return None

    def decide_roles(self, replicas: list[ReplicaModel], now: float
                     ) -> list[tuple[str, RolePoolConfig]]:
        """Role-aware decisions: at most one action per pool per round,
        returned as ``(action, pool)`` pairs with drains first (they free
        fleet budget) and scale-ups ordered most-pressured-first so the
        fleet-total budget clamp starves the *least* burning pool.  A
        "down" is only emitted when ``drain_candidate`` has a victim, so
        its freed budget slot is real.  Call after ``ingest`` +
        ``ingest_decode``; the caller applies each action and reports it
        via ``note_scaled(..., role=pool.role)``."""
        assert self.cfg.pools is not None, "decide_roles needs cfg.pools"
        self._last_check = now
        total = sum(1 for r in replicas if r.schedulable())
        fleet_max = (self.cfg.fleet_max_replicas
                     if self.cfg.fleet_max_replicas is not None
                     else sum(p.max_replicas for p in self.cfg.pools))
        ups: list[tuple[float, RolePoolConfig]] = []
        out: list[tuple[str, RolePoolConfig]] = []
        for pool in self.cfg.pools:
            st = self._pool_state[pool.role]
            n = sum(1 for r in replicas
                    if r.schedulable() and r.role == pool.role)
            burn = self.pool_burn(pool)
            if burn > pool.scale_up_burn:
                st.up_streak += 1
                st.down_streak = 0
            elif burn < pool.scale_down_burn:
                st.down_streak += 1
                st.up_streak = 0
            else:
                st.up_streak = st.down_streak = 0
            if (st.up_streak >= pool.up_patience
                    and n < pool.max_replicas
                    and now - st.last_up >= pool.cooldown_up):
                ups.append((burn / max(pool.scale_up_burn, 1e-9), pool))
            elif (st.down_streak >= pool.down_patience
                    and n > pool.min_replicas
                    and now - st.last_scale >= pool.cooldown_down
                    # Emit the drain (and free its budget slot) only if a
                    # victim actually exists: the never-strand guard can
                    # refuse the last role-capable replica, and counting
                    # that phantom drain would let same-round scale-ups
                    # breach the fleet clamp every round.
                    and self.drain_candidate(replicas, pool=pool)
                    is not None):
                out.append(("down", pool))
                total -= 1
        for _, pool in sorted(ups, key=lambda bp: -bp[0]):
            if total >= fleet_max:
                break                      # fleet budget exhausted
            out.append(("up", pool))
            total += 1
        return out

    def make_scheduler(self, now: float = 0.0) -> BaseScheduler:
        """Build the scheduler for a scale-up replica: the configured
        factory, warm-started from the fleet's current global policy when a
        store is attached (``PolicyStore.warm_start`` — the same single
        implementation the cluster simulator's ``add_replica`` uses, so the
        two scale-up paths can never diverge).  A fresh replica should not
        relearn queue boundaries the fleet already knows."""
        sched = self.scheduler_factory()
        if self.policy_store is not None:
            self.policy_store.warm_start(sched, now=now)
        return sched

    def drain_candidate(self, replicas: list[ReplicaModel],
                        pool: RolePoolConfig | None = None
                        ) -> Optional[ReplicaModel]:
        """Least-loaded schedulable replica — but never the last prefill- or
        decode-capable one (scaling down must not strand a role).  With
        ``pool`` set, candidates are restricted to that pool's role and its
        own ``min_replicas`` floor applies."""
        alive = [r for r in replicas if r.schedulable()]
        if pool is not None:
            members = [r for r in alive if r.role == pool.role]
            floor = pool.min_replicas
        else:
            members = alive
            floor = self.cfg.min_replicas
        if len(members) <= floor:
            return None
        prefill = [r for r in alive if r.accepts_prefill()]
        decode = [r for r in alive if r.accepts_decode()]
        cand = [r for r in members
                if not (r.accepts_prefill() and len(prefill) <= 1)
                and not (r.accepts_decode() and len(decode) <= 1)]
        if not cand:
            return None
        return min(cand, key=lambda r: (r.sched.waiting() + r.inflight()
                                        + len(r.inbox), r.replica_id))

    def note_scaled(self, action: str, replica: ReplicaModel,
                    now: float, role: str | None = None) -> None:
        """Record an applied action (resets streaks, starts cooldowns)."""
        burn = dict(self.burn)
        burn["decode"] = self.decode_burn
        self.events.append(ScaleEvent(time=now, action=action,
                                      replica_id=replica.replica_id,
                                      burn=burn, role=role or replica.role))
        self._last_scale = now
        if action == "up":
            self._last_up = now
        self._up_streak = 0
        self._down_streak = 0
        if role is not None and role in self._pool_state:
            st = self._pool_state[role]
            st.last_scale = now
            if action == "up":
                st.last_up = now
            st.up_streak = st.down_streak = 0

    def stats(self) -> dict:
        """Burn levels + the applied scale-event log."""
        return {"burn": dict(self.burn),
                "decode_burn": self.decode_burn,
                "events": [(e.time, e.action, e.replica_id, e.role)
                           for e in self.events],
                "scale_ups": sum(1 for e in self.events if e.action == "up"),
                "scale_downs": sum(1 for e in self.events
                                   if e.action == "down"),
                "by_role": {role: {"ups": sum(1 for e in self.events
                                              if e.role == role
                                              and e.action == "up"),
                                   "downs": sum(1 for e in self.events
                                                if e.role == role
                                                and e.action == "down")}
                            for role in {e.role for e in self.events}}}
