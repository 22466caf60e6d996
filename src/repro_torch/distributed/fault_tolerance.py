"""Legacy multi-pod controller, migrated onto the ``repro_torch.cluster``
data plane.

``ClusterController`` keeps its original control-plane API (global EWSJF
admission + pod routing + failure handling + checkpointing) but the pods
are now real ``cluster.ReplicaModel`` executors: each pod runs its own
discrete-event engine (chunked prefill + multi-step decode over the cost
model) instead of the old coarse "charge a service time" actor, and health
detection is the shared ``cluster.HealthMonitor``.

New code should use ``repro_torch.cluster`` directly — per-replica schedulers,
pluggable routers, SLO admission, disaggregated prefill/decode.  This
module remains for the global-admission topology (one EWSJF scheduler in
front of executor-only pods) and for checkpoint compatibility.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from ..cluster.health import HealthConfig, HealthMonitor
from ..cluster.replica import ReplicaModel, ReplicaParams
from ..core.batch_builder import BatchBudget
from ..core.cost_model import CostModel
from ..core.scheduler import BaseScheduler, FCFSScheduler

# Legacy alias: PodState is now the full replica executor.
PodState = ReplicaModel


@dataclass
class ClusterConfig:
    """Pods, health thresholds and per-pod limits of one controller."""

    n_pods: int = 2
    heartbeat_timeout: float = 5.0
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2            # kept for API compat (EWMA lives in
    max_inflight_per_pod: int = 64     # ReplicaModel now)
    pod_prefill_tokens: int = 8192


class ClusterController:
    """Global EWSJF admission + pod routing + failure handling (legacy
    topology: one strategic scheduler, executor-only pods)."""

    def __init__(self, scheduler: BaseScheduler, cost: CostModel,
                 ccfg: ClusterConfig | None = None,
                 policy_store=None, cell_id: int | None = None):
        self.sched = scheduler
        self.cost = cost
        self.cfg = ccfg or ClusterConfig()
        # Optional fleet PolicyStore shared across *cells* (each controller
        # is one cell with one global strategic scheduler): the controller
        # publishes its scheduler's observations and adopts the merged
        # policy during ``advance`` — same epochs/staleness semantics as
        # ``cluster.ClusterSimulator``.  cell_id defaults to a store-issued
        # unique key so co-located cells never collide.
        self.policy_store = policy_store
        if cell_id is None and policy_store is not None:
            cell_id = policy_store.issue_party_key()
        self.cell_id = cell_id
        self.now = 0.0
        self.finished: list = []
        self.reenqueued = 0
        self.pods: dict[int, ReplicaModel] = {}
        for _ in range(self.cfg.n_pods):
            self.add_pod()
        self.monitor = HealthMonitor(HealthConfig(
            heartbeat_timeout=self.cfg.heartbeat_timeout,
            straggler_factor=self.cfg.straggler_factor,
            check_interval=0.0))        # legacy: check on every call

    def _pod_params(self) -> ReplicaParams:
        return ReplicaParams(max_num_seqs=self.cfg.max_inflight_per_pod,
                             max_prefill_tokens=self.cfg.pod_prefill_tokens)

    # ---- membership / elasticity -----------------------------------------

    def add_pod(self, speed: float = 1.0) -> int:
        """Start a pod (an FCFS ``ReplicaModel``) of relative ``speed``;
        returns its id."""
        pid = max(self.pods) + 1 if self.pods else 0
        pod = ReplicaModel(pid, self.cost, scheduler=FCFSScheduler(),
                           params=self._pod_params(), speed=speed)
        pod.last_heartbeat = self.now
        pod.busy_until = self.now
        self.pods[pid] = pod
        return pid

    def remove_pod(self, pod_id: int, graceful: bool = True) -> None:
        """Drain a pod back into the global queue, or fail it at once
        (``graceful`` off): its in-flight requests are re-enqueued."""
        pod = self.pods[pod_id]
        if graceful:
            for req in pod.start_drain():
                self.sched.submit(req, now=self.now)
        else:
            self._fail_pod(pod)

    # ---- failure handling ---------------------------------------------------

    def _fail_pod(self, pod: ReplicaModel) -> None:
        for req in pod.fail():
            self.sched.submit(req, now=self.now)
            self.reenqueued += 1

    def heartbeat(self, pod_id: int, step_latency: float) -> None:
        """Record a pod's heartbeat and fold its step latency into the
        pod's EWMA."""
        pod = self.pods[pod_id]
        pod.last_heartbeat = self.now
        a = self.cfg.ewma_alpha
        pod.step_ewma = ((1 - a) * pod.step_ewma + a * step_latency
                         if pod.step_ewma else step_latency)
        pod.ewma_obs += 1

    def check_health(self) -> list[int]:
        """Detect dead + straggler pods. Returns affected pod ids."""
        dead, drain = self.monitor.check(self.pods.values(), self.now)
        for pod in dead:
            self._fail_pod(pod)
        for pod in drain:
            for req in pod.start_drain():
                self.sched.submit(req, now=self.now)
        return [p.replica_id for p in dead + drain]

    # ---- routing ----------------------------------------------------------

    def schedulable_pods(self) -> list[ReplicaModel]:
        """Live, undrained pods below their in-flight limit."""
        return [p for p in self.pods.values()
                if p.schedulable()
                and p.inflight() + p.sched.waiting()
                < self.cfg.max_inflight_per_pod]

    def route_step(self) -> int:
        """One admission round: the global EWSJF scheduler picks the batch,
        the router places it on the least-loaded schedulable pod (the pod's
        own engine then prefils/decodes it under the cost model)."""
        pods = self.schedulable_pods()
        if not pods or self.sched.waiting() == 0:
            return 0
        # backlog_cost is already speed-adjusted and exec_residual is wall
        # time — no further /speed (mirrors cluster.LeastLoadedRouter)
        pod = min(pods, key=lambda p: (
            p.exec_residual(self.now) + p.backlog_cost(self.now),
            p.replica_id))
        budget = BatchBudget(
            max_requests=self.cfg.max_inflight_per_pod
            - pod.inflight() - pod.sched.waiting(),
            max_tokens=self.cfg.pod_prefill_tokens)
        plan = self.sched.tick(self.now, budget)
        for req in plan.requests:
            pod.submit(req, self.now)
        if plan.requests:
            pod.busy_until = max(pod.busy_until, self.now)
        return len(plan.requests)

    def sync_policy(self) -> None:
        """One strategic-plane round against the shared store
        (``PolicyStore.sync``: per-cell publish cadence, store-wide merge
        cadence, ungated adoption — cells never starve each other).  No-op
        without a store or a strategic scheduler."""
        if self.policy_store is not None:
            self.policy_store.sync(self.sched, self.cell_id, self.now)

    def advance(self, dt: float) -> None:
        """Advance simulated time; each pod's engine steps until it catches
        up with the new clock."""
        self.now += dt
        self.sync_policy()
        for pod in self.pods.values():
            if not pod.alive:
                continue
            while pod.alive and pod.has_work() and pod.busy_until <= self.now:
                step_dt = pod.step(pod.busy_until)
                pod.busy_until += step_dt
            # synthetic heartbeat (the legacy controller polls its pods)
            self.heartbeat(pod.replica_id,
                           step_latency=1.0 / max(pod.speed, 1e-6))
            for req in pod.finished:
                self.finished.append(req)
                # the *global* scheduler owns the strategic loop; feed its
                # monitor (the pod's local FCFS on_finish is a no-op)
                self.sched.on_finish(req, self.now)
            pod.finished.clear()

    # ---- scheduler-state checkpointing ---------------------------------------

    def save_state(self, path: str | Path) -> None:
        """Write the clock, the scheduler's state and each pod's speed and
        liveness to ``path`` as JSON."""
        state = {"now": self.now,
                 "scheduler": self.sched.state_dict(),
                 "pods": {pid: {"speed": p.speed, "alive": p.alive}
                          for pid, p in self.pods.items()}}
        Path(path).write_text(json.dumps(state))

    def load_state(self, path: str | Path) -> None:
        """Restore the clock and the scheduler's state from ``path``."""
        state = json.loads(Path(path).read_text())
        self.now = state["now"]
        self.sched.load_state_dict(state["scheduler"])
