"""Collective and neighbor ops over the process group."""

from .collectives import allreduce, barrier, broadcast
from .neighbors import neighbor_allreduce
from .plan import CombinePlan, apply_plan

__all__ = [
    "allreduce",
    "barrier",
    "broadcast",
    "neighbor_allreduce",
    "CombinePlan",
    "apply_plan",
]
