"""Distribution: the legacy multi-pod controller (global EWSJF admission,
pod routing, failure handling, elasticity), a copy of the JAX package's
``distributed/fault_tolerance.py``; the sharding rules
(``sharding.py``) and the running of models on DTensors (``spmd.py``).

The controller's names load on first use, so that the models can import
``spmd`` without loading the serving stack the controller imports."""

__all__ = ["ClusterController", "ClusterConfig", "PodState"]


def __getattr__(name):
    if name in __all__:
        from . import fault_tolerance
        return getattr(fault_tolerance, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
