"""Cluster data plane: EWSJF-aware multi-replica routing, disaggregated
prefill/decode pools, SLO admission control, and a cluster-level
discrete-event simulator (all CPU-benchmarkable via core's cost model).

    from repro_torch.cluster import (ReplicaModel, ClusterSimulator,
                                     make_router, AdmissionController,
                                     make_fleet)
"""

from __future__ import annotations

from typing import Callable, Optional

from ..core.cost_model import CostModel
from ..core.scheduler import BaseScheduler, FCFSScheduler
from ..kvplane import (LinkTopology, LinkTopologyConfig, PrefixDirectory,
                       PrefixDirectoryConfig, PrefixFetch)
from .admission import (DEFAULT_SLO_CLASSES, AdmissionConfig,
                        AdmissionController, AdmissionDecision, SLOClass,
                        classify_by_length)
from .autoscaler import (AutoscalerConfig, RolePoolConfig, ScaleEvent,
                         SLOBurnAutoscaler)
from .disagg import HandoffChannel, KVHandoff
from .health import HealthConfig, HealthMonitor
from .policy_store import (GlobalPolicy, PolicyStore, PolicyStoreConfig,
                           ReplicaObservation)
from .replica import ReplicaModel, ReplicaParams
from .router import (EWSJFRouter, LeastLoadedRouter, RoundRobinRouter,
                     Router, make_router)
from .simulator import (ClusterSimResult, ClusterSimulator, ScenarioEvent,
                        run_router_comparison)


def make_fleet(n: int, cost: CostModel,
               scheduler_factory: Callable[[], BaseScheduler] = FCFSScheduler,
               params: Optional[ReplicaParams] = None,
               roles: Optional[list[str]] = None,
               speeds: Optional[list[float]] = None) -> list[ReplicaModel]:
    """Build ``n`` replicas, each with its own scheduler instance.  ``roles``
    /``speeds`` are per-replica overrides (e.g. ['prefill', 'prefill',
    'decode', 'decode'] for a disaggregated 2P/2D fleet)."""
    fleet = []
    for i in range(n):
        fleet.append(ReplicaModel(
            i, cost, scheduler=scheduler_factory(),
            params=params or ReplicaParams(),
            role=roles[i] if roles else "unified",
            speed=speeds[i] if speeds else 1.0))
    return fleet


__all__ = [
    "AdmissionConfig", "AdmissionController", "AdmissionDecision", "SLOClass",
    "DEFAULT_SLO_CLASSES", "classify_by_length",
    "AutoscalerConfig", "RolePoolConfig", "ScaleEvent", "SLOBurnAutoscaler",
    "HandoffChannel", "KVHandoff",
    "HealthConfig", "HealthMonitor",
    "GlobalPolicy", "PolicyStore", "PolicyStoreConfig", "ReplicaObservation",
    "LinkTopology", "LinkTopologyConfig", "PrefixDirectory",
    "PrefixDirectoryConfig", "PrefixFetch",
    "ReplicaModel", "ReplicaParams",
    "Router", "RoundRobinRouter", "LeastLoadedRouter", "EWSJFRouter",
    "make_router",
    "ClusterSimulator", "ClusterSimResult", "ScenarioEvent",
    "run_router_comparison", "make_fleet",
    "EngineFleet", "EngineReplica", "FleetStats",
]


def __getattr__(name):
    """Lazy attribute hook: ``engine_fleet`` pulls in ``serving.engine``
    (torch), so it is imported only on first access to keep the DES-only
    import path light for simulator tests and tooling."""
    if name in ("EngineFleet", "EngineReplica", "FleetStats"):
        from . import engine_fleet
        return getattr(engine_fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
