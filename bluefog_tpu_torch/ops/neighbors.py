"""Neighbor collectives: weighted averaging over the virtual topology.

Counterpart of ``bluefog_tpu/ops/neighbors.py`` (``_static_weight_matrix``
:72, ``_dynamic_weight_matrix`` :133, ``neighbor_allreduce`` :333). Each
process passes ITS OWN tensor (one process per rank) and gets back

    W[j,j] * x[j] + sum_{i in N_in(j)} W[i,j] * x[i]

for its rank j. The weight arguments keep the JAX package's global form, so
every process derives the same combine matrix W from the same arguments:

  * static unweighted topology -> uniform 1/(indegree+1) averaging
  * static weighted topology   -> the graph's recv weights (GetRecvWeights)
  * explicit ``self_weight``/``neighbor_weights`` -> user-specified combine
    (a scalar or per-rank dict; a flat {src: w} or a per-rank nested dict)
  * dynamic ``send_neighbors`` (every rank's destination list) -> per-step
    edge sets; receiving weights must be supplied, and
    ``enable_topo_check`` validates the send/recv pattern locally.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import topology as topology_util
from ..runtime.state import _global_state
from .plan import CombinePlan, apply_plan

Weights = Union[float, Dict[int, float]]
NestedWeights = Union[Dict[int, float], Dict[int, Dict[int, float]]]


def _per_rank(value, size: int, what: str) -> List:
    """Broadcast a scalar-or-dict per-rank argument to a dense list."""
    if isinstance(value, dict):
        missing = set(range(size)) - set(value)
        if missing:
            raise ValueError(
                f"{what} missing entries for ranks {sorted(missing)}")
        return [value[r] for r in range(size)]
    return [value] * size


def _static_weight_matrix(self_weight, neighbor_weights) -> np.ndarray:
    """W for the current static topology, honoring user weight overrides."""
    st = _global_state()
    n = st.size
    W = np.zeros((n, n), dtype=np.float64)
    if self_weight is None and neighbor_weights is None:
        if st.is_topo_weighted:
            for r in range(n):
                sw, nw = topology_util.GetRecvWeights(st.topology, r)
                W[r, r] = sw
                for src, w in nw.items():
                    W[src, r] = w
        else:
            for r in range(n):
                nbrs = topology_util.in_neighbor_ranks(st.topology, r)
                u = 1.0 / (len(nbrs) + 1)
                W[r, r] = u
                for src in nbrs:
                    W[src, r] = u
        return W
    if (self_weight is None) != (neighbor_weights is None):
        raise ValueError(
            "self_weight and neighbor_weights must be given together")
    sw_list = _per_rank(self_weight, n, "self_weight")
    in_nbrs = {r: set(topology_util.in_neighbor_ranks(st.topology, r))
               for r in range(n)}
    first = next(iter(neighbor_weights.values()), None)
    if isinstance(first, dict):
        nw_per_rank = _per_rank(neighbor_weights, n, "neighbor_weights")
        for r in range(n):
            extra = set(nw_per_rank[r]) - in_nbrs[r]
            if extra:
                raise ValueError(
                    f"neighbor_weights for rank {r} contain "
                    f"non-in-neighbor ranks {sorted(extra)}")
    else:
        # flat {src: w}: each rank applies the entries naming its actual
        # in-neighbors (reference mpi_ops.py:440-460, for all ranks at once)
        union = set().union(*in_nbrs.values()) if in_nbrs else set()
        extra = set(neighbor_weights) - union
        if extra:
            raise ValueError(
                f"neighbor_weights reference ranks {sorted(extra)} that "
                f"are not in-neighbors of any rank")
        nw_per_rank = [
            {s: w for s, w in neighbor_weights.items() if s in in_nbrs[r]}
            for r in range(n)]
    for r in range(n):
        W[r, r] = sw_list[r]
        for src, w in nw_per_rank[r].items():
            W[src, r] = w
    return W


def _dynamic_weight_matrix(size: int, send_neighbors, self_weight,
                           neighbor_weights,
                           enable_topo_check: bool) -> np.ndarray:
    """W for one dynamic step from every rank's send list + recv weights."""
    if isinstance(send_neighbors, dict):
        send_map = {r: list(send_neighbors.get(r, [])) for r in range(size)}
    else:
        if len(send_neighbors) != size:
            raise ValueError(
                "send_neighbors must map every rank to its destination list")
        send_map = {r: list(send_neighbors[r]) for r in range(size)}
    for r, dsts in send_map.items():
        if len(set(dsts)) != len(dsts):
            raise ValueError(f"send_neighbors[{r}] has duplicate ranks")
    if self_weight is None or neighbor_weights is None:
        raise ValueError(
            "self_weight and neighbor_weights are required with "
            "send_neighbors")

    recv_from: Dict[int, List[int]] = {r: [] for r in range(size)}
    for src, dsts in send_map.items():
        for dst in dsts:
            recv_from[dst].append(src)

    sw_list = _per_rank(self_weight, size, "self_weight")
    first = next(iter(neighbor_weights.values()), None)
    if isinstance(first, dict):
        nw_per_rank = {r: dict(neighbor_weights.get(r, {}))
                       for r in range(size)}
    else:
        nw_per_rank = {
            r: {s: neighbor_weights[s] for s in recv_from[r]
                if s in neighbor_weights}
            for r in range(size)}

    if enable_topo_check:
        for dst in range(size):
            expected = set(recv_from[dst])
            declared = set(nw_per_rank[dst])
            if expected != declared:
                raise RuntimeError(
                    f"dynamic topology mismatch at rank {dst}: senders "
                    f"{sorted(expected)} vs declared neighbor_weights "
                    f"{sorted(declared)} (set enable_topo_check=False to "
                    f"skip)")

    W = np.zeros((size, size), dtype=np.float64)
    for dst in range(size):
        W[dst, dst] = sw_list[dst]
        for src, w in nw_per_rank[dst].items():
            W[src, dst] = w
    return W


def _freeze(obj):
    """Hashable snapshot of weight arguments for the plan cache."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


def neighbor_plan(self_weight=None, neighbor_weights=None,
                  send_neighbors=None, enable_topo_check: bool = True,
                  force_gather: Optional[bool] = None) -> CombinePlan:
    """The (cached) combine plan for one set of weight arguments."""
    st = _global_state()
    st.check_initialized()
    key = ("nar", _freeze(send_neighbors), _freeze(self_weight),
           _freeze(neighbor_weights), bool(enable_topo_check), force_gather)
    plan = st._plan_cache.get(key)
    if plan is None:
        if send_neighbors is None:
            W = _static_weight_matrix(self_weight, neighbor_weights)
        else:
            W = _dynamic_weight_matrix(st.size, send_neighbors, self_weight,
                                       neighbor_weights, enable_topo_check)
        plan = CombinePlan(W, force_gather=force_gather)
        if len(st._plan_cache) > 4096:  # unbounded dynamic schedules
            st._plan_cache.clear()
        st._plan_cache[key] = plan
    return plan


def neighbor_allreduce(
    tensor: Union[torch.Tensor, Sequence[torch.Tensor]],
    self_weight: Optional[Weights] = None,
    neighbor_weights: Optional[NestedWeights] = None,
    send_neighbors=None,
    enable_topo_check: bool = True,
    name: Optional[str] = None,
    force_gather: Optional[bool] = None,
):
    """Weighted average of this rank's tensor with its in-neighbors'.

    ``tensor`` is a tensor or a list/tuple of tensors (each combined with
    the same plan); returns the same structure. ``name`` is accepted for
    API parity with the reference (mpi_ops.py:481-528) and not used.
    ``force_gather`` overrides the plan's strategy choice.
    """
    del name
    plan = neighbor_plan(self_weight, neighbor_weights, send_neighbors,
                         enable_topo_check, force_gather)
    if isinstance(tensor, torch.Tensor):
        return apply_plan(plan, [tensor])[0]
    return type(tensor)(apply_plan(plan, list(tensor)))
