"""Fleet-level strategic plane: a shared EWSJF policy store.

The paper's strategic loop (Refine-and-Prune partitioning + Bayesian
meta-optimization, §3.1/§4.4) runs per scheduler instance, so every replica
relearns queue boundaries from its own slice of traffic and a freshly
scaled-up replica starts from a single [0, ∞) queue with a cold posterior.
The :class:`PolicyStore` lifts that loop to the fleet — the same
amortization learning-to-rank schedulers apply to ranking state across
servers (Fu et al.):

  publish   each replica periodically exports a *strategic observation* —
            a bounded sample of its length distribution (weighted by its
            true arrival count), its Bayesian (Θ, reward) trials, and its
            per-class delay stats;
  merge     the store pools the non-stale observations: weighted
            Refine-and-Prune over the pooled length distribution → one
            global partition, pooled trials → one shared posterior whose
            best Θ becomes the global meta-parameters;
  broadcast replicas adopt the merged policy with a configurable
            *local-adaptation weight* (0 = pure global, 1 = keep local
            structure, only absorb the posterior), and the autoscaler
            warm-starts new replicas from it instead of defaults.

Every global policy carries a monotonically increasing **epoch** that
advances only when the merged structure materially changes (a stable fleet
never pays a reinstall; posterior updates flow separately).  Replicas
record the epoch they adopted and observations record the epoch their
publisher had seen; the store drops an observation as stale when its
publisher either stopped republishing for more than
``max_staleness_epochs`` merge rounds or is wedged more than that many
*epochs* behind the current policy.  Nothing ever blocks on the store: a
replica that misses a sync round keeps serving on its last-adopted (or
locally learned) policy and catches up on the next broadcast.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.meta_optimizer import pool_trials
from ..core.partition import (PartitionConfig, edge_divergence,
                              weighted_refine_and_prune)
from ..core.types import MetaParams, QueueBounds


@dataclass
class PolicyStoreConfig:
    """Sync cadence, staleness window, merge caps, and the per-replica
    ``local_adaptation`` blend weight."""
    sync_interval: float = 5.0       # publish→merge→broadcast period (s)
    local_adaptation: float = 0.25   # w: how much local structure replicas keep
    min_fleet_samples: int = 64      # don't emit a policy before this
    sample_cap: int = 2048           # per-replica published sample cap
    pooled_cap: int = 50_000         # pooled resample size for Refine-and-Prune
    trial_cap: int = 256             # shared posterior size bound
    max_staleness_epochs: int = 4    # drop observations older than this
    change_tolerance: float = 0.05   # mean relative edge movement that
                                     # counts as a new epoch (below: held)
    seed: int = 0


@dataclass
class ReplicaObservation:
    """One replica's published strategic state (see
    ``EWSJFScheduler.export_observation``)."""

    replica_id: int
    time: float
    epoch_seen: int                              # epoch the replica had adopted
    lengths: np.ndarray                          # bounded recent length sample
    n_arrivals: int                              # true arrival count (weight)
    trials: list = field(default_factory=list)   # [(theta, reward), ...]
    edges: list = field(default_factory=list)    # installed interior edges
    max_queues: int = 32                         # replica's configured budget
    class_delays: dict = field(default_factory=dict)  # name -> (mean_wait, n)
    predictor: Optional[dict] = None             # length-posterior export
                                                 # (repro_torch.predict state dict)


@dataclass
class GlobalPolicy:
    """One merged fleet policy.  Structure (boundaries/meta) is immutable
    once built — replicas compare ``epoch`` against their last-adopted
    epoch to decide whether to reinstall; only ``trials`` is refreshed in
    place on structurally-stable merge rounds (posterior updates propagate
    without an epoch bump)."""

    epoch: int
    boundaries: list[QueueBounds]
    meta: MetaParams
    trials: list                                 # pooled posterior
    n_samples: int                               # pooled length-sample size
    n_replicas: int                              # contributing replicas
    built_at: float = 0.0
    class_delays: dict = field(default_factory=dict)
    # Pooled fleet output-length posterior (prediction plane).  Like
    # ``trials``, it rides *outside* the epoch: refreshed in place on
    # structurally-stable merge rounds and pushed to replicas through the
    # rev-guarded ``_absorb_predictor`` path, never forcing a reinstall.
    predictor_state: Optional[dict] = None


class PolicyStore:
    """Shared strategic state for a fleet of EWSJF replicas.

    The store is passive: the control plane (cluster simulator, serving
    engine, or an operator loop) drives ``publish``/``merge`` and broadcasts
    ``current()`` to replicas.  ``merge`` is cheap enough to run inline —
    cost is bounded by ``pooled_cap`` regardless of fleet traffic."""

    def __init__(self, cfg: PolicyStoreConfig | None = None):
        self.cfg = cfg or PolicyStoreConfig()
        self._obs: dict[int, ReplicaObservation] = {}
        self._pub_round: dict[int, int] = {}      # merge round at publish
        self._policy: Optional[GlobalPolicy] = None
        self._last_sync = float("-inf")
        self._party_last: dict[int, float] = {}   # per-party publish clocks
        self._next_issued_key = -1                # auto keys for sync parties
        self._round = 0                           # merge rounds (staleness clock)
        self.trials_rev = 0                       # bumped when pooled trials change
        self.predictor_rev = 0                    # bumped when pooled length-
                                                  # posterior changes
        self.merges = 0
        self.publishes = 0
        self.stale_dropped = 0
        self.edge_divergence: Optional[float] = None

    # ---- sync-loop cadence -------------------------------------------------

    def due(self, now: float) -> bool:
        """Whether a merge round is owed on the store-wide cadence."""
        return now - self._last_sync >= self.cfg.sync_interval

    def issue_party_key(self) -> int:
        """Unique key for an independent sync party (engine / cell) whose
        caller didn't pick one.  Issued keys are negative so they can never
        collide with cluster replica ids (which are ≥ 0) — two parties
        silently sharing a key would overwrite each other's observations
        and starve each other's publish cadence."""
        key = self._next_issued_key
        self._next_issued_key -= 1
        return key

    # ---- sync protocol (the one implementation every driver shares) --------

    def _adopt_into(self, sched, now: float) -> bool:
        """Install the current policy into one scheduler if it is behind —
        either on a new epoch, or on the *same* epoch after the scheduler
        repartitioned locally since adopting (so per-replica drift is
        re-aligned without bumping the epoch fleet-wide).  Idempotent
        otherwise, and never rate-limited — a party must be able to catch
        up even when another party owns the merge cadence."""
        pol = self._policy
        if pol is None or not hasattr(sched, "adopt_global_policy"):
            return False
        self._absorb_predictor(sched)
        behind = sched.adopted_epoch < pol.epoch
        drifted = (sched.adopted_epoch == pol.epoch
                   and getattr(sched, "reopt_count", 0)
                   != getattr(sched, "_reopt_at_adopt", -1))
        if not (behind or drifted):
            # Structural no-op — but still absorb newly pooled trials so
            # the shared posterior propagates across the fleet without
            # paying a queue reinstall.  Rev-guarded: merge_trials dedups
            # so re-merging is idempotent, but callers sit in hot loops.
            if (pol.trials and hasattr(sched, "meta_opt")
                    and getattr(sched, "_trials_rev_seen", -1)
                    != self.trials_rev):
                sched.meta_opt.merge_trials(pol.trials)
                sched._trials_rev_seen = self.trials_rev
            return False
        sched.adopt_global_policy(
            pol.boundaries, pol.meta, trials=pol.trials,
            local_weight=self.cfg.local_adaptation, now=now,
            epoch=pol.epoch)
        sched._trials_rev_seen = self.trials_rev
        return True

    def warm_start(self, sched, now: float = 0.0) -> bool:
        """Cold-start a scheduler that has never adopted a fleet policy —
        the single warm-start implementation used by the cluster
        simulator's ``add_replica`` and the autoscaler's scale-up path.
        No-op (returns False) without a merged policy, for schedulers
        without the hook, or if the scheduler already adopted an epoch."""
        pol = self._policy
        if (pol is None or not hasattr(sched, "warm_start_from")
                or sched.adopted_epoch >= 0):
            return False
        sched.warm_start_from(pol.boundaries, pol.meta, trials=pol.trials,
                              now=now, epoch=pol.epoch)
        self._absorb_predictor(sched)
        return True

    def _absorb_predictor(self, sched) -> None:
        """Push the pooled fleet length-posterior into one scheduler's
        predictor.  Rev-guarded **on the predictor object** (not the
        scheduler): the cluster simulator threads one shared predictor
        through every replica, and re-merging the same global state per
        scheduler would re-pool identical samples into the bounded windows
        once per replica instead of once per revision."""
        pol = self._policy
        pred = getattr(sched, "predictor", None)
        if pol is None or pol.predictor_state is None or pred is None:
            return
        if getattr(pred, "_pred_rev_seen", -1) == self.predictor_rev:
            return
        pred.merge_state(pol.predictor_state)
        pred._pred_rev_seen = self.predictor_rev

    def _publish_from(self, sched, replica_id: int, now: float,
                      class_delays: Optional[dict]) -> None:
        self.publish(ReplicaObservation(
            replica_id=replica_id, time=now,
            epoch_seen=sched.adopted_epoch,
            class_delays=class_delays or {},
            **sched.export_observation(sample_cap=self.cfg.sample_cap)))

    def sync(self, sched, replica_id: int, now: float,
             class_delays: Optional[dict] = None) -> Optional[GlobalPolicy]:
        """One *independent party's* strategic round (serving engines or
        controller cells sharing a store, each on its own clock): publish
        this party's observation on its own per-party cadence, run a merge
        on the store-wide cadence, and always offer the current policy for
        adoption — so a party whose clock lags the merge owner still
        publishes and catches up instead of being starved by the shared
        ``due()`` gate.  Safe to call every loop iteration."""
        if not hasattr(sched, "export_observation"):
            return self._policy
        last = self._party_last.get(replica_id, float("-inf"))
        if now - last >= self.cfg.sync_interval:
            self._party_last[replica_id] = now
            self._publish_from(sched, replica_id, now, class_delays)
            if self.due(now):
                self.merge(now)
        self._adopt_into(sched, now)
        return self._policy

    def sync_fleet(self, parties, now: float) -> Optional[GlobalPolicy]:
        """One fleet-wide strategic round driven by a single control loop
        (the cluster simulator): publish every party's observation, merge
        once, broadcast to everyone.  ``parties`` yields
        ``(replica_id, sched, class_delays)``; the caller owns the cadence
        (gate on ``due``)."""
        parties = list(parties)
        for replica_id, sched, class_delays in parties:
            if hasattr(sched, "export_observation"):
                self._party_last[replica_id] = now
                self._publish_from(sched, replica_id, now, class_delays)
        self.merge(now)
        for _, sched, _ in parties:
            self._adopt_into(sched, now)
        return self._policy

    # ---- publish -----------------------------------------------------------

    def publish(self, obs: ReplicaObservation) -> None:
        """Record a replica's latest observation (last-writer-wins per
        replica; the store never blocks the publisher)."""
        self._obs[obs.replica_id] = obs
        self._pub_round[obs.replica_id] = self._round
        self.publishes += 1

    def forget(self, replica_id: int) -> None:
        """Drop a failed/drained replica's observation immediately (its
        traffic sample would otherwise linger until staleness expiry)."""
        self._obs.pop(replica_id, None)
        self._pub_round.pop(replica_id, None)
        self._party_last.pop(replica_id, None)

    # ---- merge -------------------------------------------------------------

    def _fresh_observations(self) -> list[ReplicaObservation]:
        """Drop stale observations on two clocks, keep the rest:

        * **merge rounds** — a publisher that stopped republishing within
          ``max_staleness_epochs`` rounds is gone (rounds rather than
          epochs here, because epochs freeze while the policy is stable
          and a frozen clock would keep a dead publisher's traffic in the
          pool forever);
        * **policy epochs** — a publisher stuck more than
          ``max_staleness_epochs`` epochs behind the current policy
          (``epoch_seen``) is wedged: it keeps publishing but never
          adopts, so its strategic state no longer reflects the fleet's.
        """
        epoch = self._policy.epoch if self._policy else 0
        fresh, stale = [], []
        for obs in self._obs.values():
            round_gap = self._round - self._pub_round.get(obs.replica_id, 0)
            # epoch_seen < 0 = a *new* party that has simply not adopted
            # yet (publish runs before adopt in the sync protocol), not a
            # wedged one — only ever-adopted publishers can be epoch-stale.
            epoch_gap = (epoch - obs.epoch_seen if obs.epoch_seen >= 0
                         else 0)
            if (round_gap > self.cfg.max_staleness_epochs
                    or epoch_gap > self.cfg.max_staleness_epochs):
                stale.append(obs.replica_id)
            else:
                fresh.append(obs)
        for rid in stale:
            self._obs.pop(rid, None)
            self._pub_round.pop(rid, None)
            self._party_last.pop(rid, None)   # same cleanup as forget()
            self.stale_dropped += 1
        return fresh

    def merge(self, now: float) -> Optional[GlobalPolicy]:
        """Pool the fresh observations into the next global policy.  Returns
        the current policy, or None when the fleet hasn't observed enough
        traffic yet (replicas keep their local policies).  The epoch only
        advances when the merged result *materially changed* (boundaries,
        meta, or pooled trials) — a stable fleet must not pay a full
        policy-reinstall (queue rebuild + snapshot/router cache
        invalidation) on every sync round for an identical policy."""
        self._last_sync = now
        self._round += 1
        fresh = self._fresh_observations()
        pools = [obs.lengths for obs in fresh if len(obs.lengths)]
        weights = [obs.n_arrivals for obs in fresh if len(obs.lengths)]
        if sum(len(p) for p in pools) < self.cfg.min_fleet_samples:
            return None

        # Shared posterior: pool every replica's trials (plus the previous
        # global posterior so fleet knowledge survives replica churn) under
        # the same dedup/cap semantics replicas use locally.
        trials = pool_trials(
            self._policy.trials if self._policy else [],
            (t for obs in fresh for t in obs.trials),
            self.cfg.trial_cap)

        # Pooled length posterior (prediction plane): union the fresh
        # replicas' empirical predictor exports with the previous global
        # state, so decode-length knowledge survives replica churn the same
        # way the Θ posterior does.  Import is deferred — the predict
        # package is optional for stores serving predictor-less fleets.
        pred_states = [obs.predictor for obs in fresh if obs.predictor]
        if self._policy is not None and self._policy.predictor_state:
            pred_states.append(self._policy.predictor_state)
        if pred_states:
            from ..predict import merge_states
            pred_state: Optional[dict] = merge_states(pred_states)
        else:
            pred_state = None
        pred_changed = (pred_state is not None
                        and (self._policy is None
                             or pred_state != self._policy.predictor_state))

        # Global queue budget: the tightest configured budget in the fleet
        # (trials carry only the 7 scoring dims, so the budget must come
        # from the replicas' configs — defaulting would silently override
        # an operator's max_queues with 32).
        budget = min((obs.max_queues for obs in fresh), default=32)

        # Global meta-parameters: the pooled posterior's best Θ (falling
        # back to the hand-tuned defaults before any trial completed).
        if trials:
            best = max(trials, key=lambda t: t[1])
            meta = MetaParams.from_vector(best[0], max_queues=budget)
        else:
            meta = MetaParams(max_queues=budget)

        # Global partition: weighted Refine-and-Prune over the pooled
        # distribution, under the global meta's α_split / queue budget.
        epoch = (self._policy.epoch + 1) if self._policy else 1
        pcfg = PartitionConfig(alpha_split=meta.alpha_split,
                               max_queues=budget)
        boundaries = weighted_refine_and_prune(
            pools, weights, cfg=pcfg, cap=self.cfg.pooled_cap,
            seed=self.cfg.seed)

        self.merges += 1
        self.edge_divergence = self._edge_divergence(fresh, boundaries)
        if self._policy is not None and not self._changed(boundaries, meta):
            # Stable structure: keep the epoch (no fleet-wide reinstall),
            # but refresh the pooled posterior — _adopt_into propagates it
            # to replicas as a cheap merge_trials, not a policy install —
            # and the telemetry fields, which describe the *current* fleet
            # (a shrunk fleet must not keep reporting its old size).
            if trials != self._policy.trials:
                self._policy.trials = trials
                self.trials_rev += 1
            if pred_changed:
                self._policy.predictor_state = pred_state
                self.predictor_rev += 1
            self._policy.n_replicas = len(fresh)
            self._policy.n_samples = int(min(self.cfg.pooled_cap,
                                             sum(len(p) for p in pools)))
            self._policy.class_delays = self._merge_class_delays(fresh)
            self._policy.built_at = now
            return self._policy
        self._policy = GlobalPolicy(
            epoch=epoch, boundaries=boundaries, meta=meta, trials=trials,
            n_samples=int(min(self.cfg.pooled_cap,
                              sum(len(p) for p in pools))),
            n_replicas=len(fresh), built_at=now,
            class_delays=self._merge_class_delays(fresh),
            predictor_state=pred_state)
        self.trials_rev += 1
        if pred_changed:
            self.predictor_rev += 1
        return self._policy

    def _changed(self, boundaries, meta) -> bool:
        """Structural change test for the epoch bump: meta-parameters, queue
        count, and *materially moved* edges.  The pooled sample shifts a
        little every round as new arrivals land, so exact-float boundary
        comparison would bump the epoch — and force a fleet-wide queue
        reinstall — on every sync; edges within ``change_tolerance`` mean
        relative movement hold the epoch.  Trials are excluded entirely
        (the pooled list grows on virtually every round); they flow
        separately via merge_trials."""
        prev = self._policy
        if (meta.as_vector() != prev.meta.as_vector()
                or meta.max_queues != prev.meta.max_queues
                or len(boundaries) != len(prev.boundaries)):
            return True
        div = edge_divergence([b.hi for b in boundaries[:-1]],
                              [b.hi for b in prev.boundaries[:-1]])
        # div is None only when both partitions are single-queue (equal
        # counts already checked) — structurally identical.
        return div is not None and div > self.cfg.change_tolerance

    @staticmethod
    def _edge_divergence(observations, boundaries) -> Optional[float]:
        """How far the fleet's *installed* partitions sit from the freshly
        merged one (``core.partition.edge_divergence``, observation-count
        weighted).  A convergence signal for operators — high values mean
        broadcasts aren't landing (or local adaptation is pulling hard
        against the global structure)."""
        global_edges = [b.hi for b in boundaries[:-1]]
        per_rep = [edge_divergence(obs.edges, global_edges)
                   for obs in observations]
        per_rep = [d for d in per_rep if d is not None]
        return float(np.mean(per_rep)) if per_rep else None

    @staticmethod
    def _merge_class_delays(observations) -> dict:
        """Sample-weighted mean queue delay per SLO class across the fleet
        (telemetry for operators / the admission layer)."""
        acc: dict[str, tuple[float, int]] = {}
        for obs in observations:
            for name, (mean, n) in obs.class_delays.items():
                m0, n0 = acc.get(name, (0.0, 0))
                acc[name] = ((m0 * n0 + mean * n) / max(n0 + n, 1), n0 + n)
        return acc

    # ---- read side ---------------------------------------------------------

    def current(self) -> Optional[GlobalPolicy]:
        """The latest merged global policy (None before the first merge)."""
        return self._policy

    def global_bounds(self, length: float) -> Optional[QueueBounds]:
        """The global partition interval a prompt of ``length`` belongs to
        (None before the first merge) — the router's fleet-wide queue map."""
        if self._policy is None:
            return None
        for b in self._policy.boundaries:
            if b.lo <= length < b.hi or (b.hi == float("inf")
                                         and length >= b.lo):
                return b
        return self._policy.boundaries[-1]

    def stats(self) -> dict:
        """Store telemetry: epoch, queue/trial counts, merge/publish totals."""
        pol = self._policy
        return {"epoch": pol.epoch if pol else 0,
                "merges": self.merges,
                "publishes": self.publishes,
                "stale_dropped": self.stale_dropped,
                "n_queues": len(pol.boundaries) if pol else 0,
                "n_trials": len(pol.trials) if pol else 0,
                "n_replicas": pol.n_replicas if pol else 0,
                "predictor_rev": self.predictor_rev,
                "edge_divergence": self.edge_divergence}
