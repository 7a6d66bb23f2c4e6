"""Replica placement for the spatial query service (the reference's
``launch/mesh.replica_meshes``).

The reference splits its devices into ``replicas`` disjoint groups and
gives each group a 1-D mesh, on which one replica's packed forest lives.
The port's forest has one shard, so a replica is one device: R replicas of
a CUDA fleet are ``cuda:0`` … ``cuda:R-1``.  The reference's rule stays: R
replicas need at least R visible devices of the fleet's type, and R must
divide their count.  A CPU fleet has one device, so it takes one replica,
as the reference's does on one device.
"""
from __future__ import annotations

from typing import List, Optional

import torch


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
