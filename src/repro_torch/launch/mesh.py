"""Meshes of the port (the reference's ``launch/mesh.py``).

``make_production_mesh`` and ``make_mesh`` stand for the reference's JAX
mesh builders.  The production meshes are (16, 16) ``("data", "model")``
single-pod = 256 devices and (2, 16, 16) ``("pod", "data", "model")``
multi-pod = 512.  ``pod`` is the slow inter-pod axis, ``data`` intra-pod
data parallelism, ``model`` the TP/EP axis.  The sharding rules
(``distributed/sharding.py``) and the dry run need only the axes' names
and sizes, so ``make_production_mesh`` gives a ``ShapeMesh``, which no
process group backs; ``make_mesh`` gives a real
``torch.distributed.device_mesh.DeviceMesh`` over an initialized process
group, for the DTensor placements.  The sharding functions take either.

Replica placement for the spatial query service stands for the
reference's ``replica_meshes``: the reference splits its devices into
``replicas`` disjoint groups and gives each group a 1-D mesh, on which one
replica's packed forest lives.  The port's forest has one shard, so a
replica is one device: R replicas of a CUDA fleet are ``cuda:0`` …
``cuda:R-1``.  The reference's rule stays: R replicas need at least R
visible devices of the fleet's type, and R must divide their count.  A CPU
fleet has one device, so it takes one replica, as the reference's does on
one device.  The reference's ``spatial_mesh`` (the fleet's 1-D partition
mesh, or its (replica, partition) grid) has no counterpart: the port's
fleet is one flat packed forest on one device, and ``replica_devices``
gives the replica axis.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch


class ShapeMesh:
    """A mesh's axis names and sizes, with no devices behind it: what the
    specs and the dry run read (``axis_names``, and ``shape`` as the
    mapping name → size that a JAX mesh has)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} for axes "
                             f"{tuple(axes)}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, (int(n)
                                                     for n in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"ShapeMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ShapeMesh(shape, axes)


@contextlib.contextmanager
def fake_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process
    group (``torch.testing``'s ``FakeStore``: this process is rank 0 and
    no other rank exists; collectives return at once), for as long as
    the context lasts: what the dry run traces a cell's step over on the
    meta device.  No other process group may be initialized."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over the
    default process group, which must be initialized with one rank a
    device of the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    n = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"make_mesh{shape}: no process group is initialized; call "
            f"torch.distributed.init_process_group with world size {n} "
            f"first")
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"make_mesh{shape}: the process group has "
            f"{dist.get_world_size()} ranks, the mesh needs {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def replica_devices(replicas: Optional[int] = None,
                    device="cuda") -> List[torch.device]:
    """One device per replica for a fleet on ``device``'s type: the
    devices ``replica_meshes`` would give one group each."""
    kind = torch.device(device).type
    n = torch.cuda.device_count() if kind == "cuda" else 1
    r = replicas or 1
    if r > n:
        raise ValueError(f"{r} replicas need at least {r} devices, "
                         f"have {n}")
    if n % r:
        raise ValueError(f"{n} devices do not divide into {r} "
                         f"replica groups")
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(r)]
    return [torch.device(kind)]
