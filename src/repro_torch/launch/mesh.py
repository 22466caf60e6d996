"""Production and host meshes, ported from the JAX package's
``launch/mesh.py``.

Kept as functions, so that importing this module touches no device and
creates no process group.  Single pod: 16 × 16 = 256 ranks on ("data",
"model").  Multi-pod: 2 × 16 × 16 = 512 ranks on ("pod", "data", "model"),
the "pod" axis carrying data parallelism across pods.

Both build a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, which the caller has made: NCCL on the card, gloo for CPU
ranks, or :func:`init_fake_world` for a dry run, where one process stands
for every rank of a production mesh (``torch.testing._internal.distributed
.fake_pg``: collectives return at once and move nothing).
:class:`AbstractMesh` names axes and sizes without any process group, for
the sharding rules alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, with no devices behind it (the JAX
    package's ``jax.sharding.AbstractMesh``): what
    ``distributed.sharding.ShardingPolicy``'s rules read."""

    shape: tuple
    mesh_dim_names: tuple


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def init_fake_world(world_size: int, rank: int = 0) -> None:
    """A default process group of ``world_size`` ranks held by this one
    process (backend ``"fake"``), for a dry run on meta tensors."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model"), over the default process group of 256 or 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(model_parallel: int = 1, *, device_type="cuda"):
    """A ("data", "model") mesh over every rank of the default process
    group, ``min(model_parallel, world)`` of them along "model"."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    mp = min(model_parallel, n)
    return init_device_mesh(device_type, (n // mp, mp),
                            mesh_dim_names=("data", "model"))
