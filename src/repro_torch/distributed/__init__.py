"""Distribution: the legacy multi-pod controller (global EWSJF admission,
pod routing, failure handling, elasticity), a copy of the JAX package's
``distributed/fault_tolerance.py``.  Sharding comes with a later step of
the port."""
from .fault_tolerance import ClusterConfig, ClusterController, PodState

__all__ = ["ClusterController", "ClusterConfig", "PodState"]
