"""Collective and neighbor ops over the process group."""

from .collectives import (
    allgather,
    allgather_nonblocking,
    allgather_v,
    allgather_v_nonblocking,
    allreduce,
    allreduce_,
    allreduce_nonblocking,
    allreduce_nonblocking_,
    barrier,
    broadcast,
    broadcast_,
    broadcast_nonblocking,
    broadcast_nonblocking_,
    pair_gossip,
    pair_gossip_nonblocking,
)
from .neighbors import (
    hierarchical_neighbor_allreduce,
    hierarchical_neighbor_allreduce_nonblocking,
    neighbor_allgather,
    neighbor_allgather_nonblocking,
    neighbor_allreduce,
    neighbor_allreduce_nonblocking,
)
from .plan import CombinePlan, apply_plan

__all__ = [
    "allgather",
    "allgather_nonblocking",
    "allgather_v",
    "allgather_v_nonblocking",
    "allreduce",
    "allreduce_",
    "allreduce_nonblocking",
    "allreduce_nonblocking_",
    "barrier",
    "broadcast",
    "broadcast_",
    "broadcast_nonblocking",
    "broadcast_nonblocking_",
    "pair_gossip",
    "pair_gossip_nonblocking",
    "hierarchical_neighbor_allreduce",
    "hierarchical_neighbor_allreduce_nonblocking",
    "neighbor_allgather",
    "neighbor_allgather_nonblocking",
    "neighbor_allreduce",
    "neighbor_allreduce_nonblocking",
    "CombinePlan",
    "apply_plan",
]
