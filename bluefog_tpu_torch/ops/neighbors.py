"""Neighbor collectives: weighted averaging over the virtual topology.

Counterpart of ``bluefog_tpu/ops/neighbors.py`` (``_static_weight_matrix``
:72, ``_dynamic_weight_matrix`` :133, ``neighbor_allreduce`` :333,
``hierarchical_neighbor_allreduce`` :432, ``neighbor_allgather`` :543). Each
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

import contextlib
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import topology as topology_util
from ..runtime import handles as _handles
from ..runtime.state import _global_state
from ..runtime.timeline import timeline_context
from .plan import CombinePlan, _acc_dtype, spmd_combine_start

Weights = Union[float, Dict[int, float]]
NestedWeights = Union[Dict[int, float], Dict[int, Dict[int, float]]]

_op_counter = [0]


def _auto_name(prefix: str, name: Optional[str]) -> str:
    """The op's name in the timeline and its handle: ``name``, else
    ``<prefix>.noname.<k>`` counting this process's unnamed ops (JAX
    ``neighbors.py:46-50``)."""
    if name is not None:
        return name
    _op_counter[0] += 1
    return f"{prefix}.noname.{_op_counter[0]}"


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
        if not st.is_topo_weighted:
            return _uniform_weights(st.topology, n)
        for r in range(n):
            sw, nw = topology_util.GetRecvWeights(st.topology, r)
            W[r, r] = sw
            for src, w in nw.items():
                W[src, r] = w
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
                  force_gather: Optional[bool] = None,
                  op_name: Optional[str] = None) -> CombinePlan:
    """The (cached) combine plan for one set of weight arguments. A miss
    under an ``op_name`` is that op's ``PLAN_BUILD`` activity."""
    st = _global_state()
    st.check_initialized()
    key = ("nar", _freeze(send_neighbors), _freeze(self_weight),
           _freeze(neighbor_weights), bool(enable_topo_check), force_gather)
    plan = st._plan_cache.get(key)
    if plan is None:
        with timeline_context(op_name, "PLAN_BUILD") if op_name else \
                contextlib.nullcontext():
            if send_neighbors is None:
                W = _static_weight_matrix(self_weight, neighbor_weights)
            else:
                W = _dynamic_weight_matrix(st.size, send_neighbors,
                                           self_weight, neighbor_weights,
                                           enable_topo_check)
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
    the same plan); returns the same structure. ``name`` names the op in
    the timeline (reference: mpi_ops.py:481-528). ``force_gather``
    overrides the plan's strategy choice.
    """
    return _handles.synchronize(neighbor_allreduce_nonblocking(
        tensor, self_weight, neighbor_weights, send_neighbors,
        enable_topo_check, name, force_gather))


def neighbor_allreduce_nonblocking(
    tensor: Union[torch.Tensor, Sequence[torch.Tensor]],
    self_weight: Optional[Weights] = None,
    neighbor_weights: Optional[NestedWeights] = None,
    send_neighbors=None,
    enable_topo_check: bool = True,
    name: Optional[str] = None,
    force_gather: Optional[bool] = None,
) -> int:
    """:func:`neighbor_allreduce` issued: every shift's transfers at once;
    returns a handle for ``synchronize``."""
    op_name = _auto_name("neighbor_allreduce", name)
    plan = neighbor_plan(self_weight, neighbor_weights, send_neighbors,
                         enable_topo_check, force_gather, op_name)
    with timeline_context(op_name, "NEIGHBOR_ALLREDUCE"):
        work, finish = spmd_combine_start(
            plan.weight_array(), _as_list(tensor), rank=_global_state().rank,
            n=plan.n, shifts=plan.shifts, use_gather=plan.use_gather)
    return _handles.allocate(op_name, work,
                             lambda: _like(tensor, finish()))


def _as_list(tensor) -> List[torch.Tensor]:
    return [tensor] if isinstance(tensor, torch.Tensor) else list(tensor)


def _like(tensor, outs: List[torch.Tensor]):
    """``outs`` in the structure of ``tensor`` (one tensor or a sequence)."""
    return outs[0] if isinstance(tensor, torch.Tensor) else type(tensor)(outs)


# ---------------------------------------------------------------------------
# hierarchical_neighbor_allreduce
# ---------------------------------------------------------------------------

def _uniform_weights(topo, n: int) -> np.ndarray:
    """Uniform 1/(indegree+1) combine matrix of ``topo``."""
    W = np.zeros((n, n))
    for r in range(n):
        nbrs = topology_util.in_neighbor_ranks(topo, r)
        W[r, r] = 1.0 / (len(nbrs) + 1)
        for src in nbrs:
            W[src, r] = W[r, r]
    return W


def _machine_plan(self_weight=None, neighbor_machine_weights=None,
                 send_neighbor_machines=None,
                 enable_topo_check: bool = False) -> CombinePlan:
    """The machine-level plan of ``hierarchical_neighbor_allreduce`` (JAX
    ``neighbors.py:477-497``): Expo-2 over the machines with uniform weights
    by default, else the dynamic weights given."""
    st = _global_state()
    m = st.size // st.local_size
    if send_neighbor_machines is None and neighbor_machine_weights is None:
        return CombinePlan(_uniform_weights(
            topology_util.ExponentialTwoGraph(m), m))
    if neighbor_machine_weights is None or self_weight is None:
        raise ValueError("self_weight and neighbor_machine_weights must be "
                         "given together")
    if send_neighbor_machines is None:
        raise ValueError("send_neighbor_machines is required")
    return CombinePlan(_dynamic_weight_matrix(
        m, send_neighbor_machines, self_weight, neighbor_machine_weights,
        enable_topo_check))


def hierarchical_start(plan: CombinePlan, tensors: Sequence[torch.Tensor]):
    """The f32 mean over this rank's machine, then ``plan``'s combine over
    its machine group, cast back once; returns ``(work, finish)``. The
    caller has checked the layout (``check_homogeneous``).

    The machine's mean is waited on before the machine exchange is issued
    (on CUDA the wait orders the stream, the host does not block). The
    reference's third phase, the local broadcast, is not needed: every rank
    of a machine computes the same combine (JAX ``neighbors.py:440-447``).
    """
    st = _global_state()
    means = []
    for x in tensors:
        acc = x.to(_acc_dtype(x.dtype)).clone()
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=st.local_group,
                        async_op=True).wait()
        means.append(acc / st.local_size)
    work, finish = spmd_combine_start(
        plan.weight_array(), means, rank=st.rank // st.local_size, n=plan.n,
        shifts=plan.shifts, use_gather=plan.use_gather,
        group=st.machine_group)
    return work, lambda: [o.to(x.dtype) for o, x in zip(finish(), tensors)]


def hierarchical_neighbor_allreduce(
    tensor,
    self_weight: Optional[Weights] = None,
    neighbor_machine_weights: Optional[NestedWeights] = None,
    send_neighbor_machines=None,
    enable_topo_check: bool = False,
    name: Optional[str] = None,
):
    """Machine-level neighbor averaging: the mean over this rank's machine,
    then the weighted combine of the machines' means over the machine graph
    (reference: mpi_ops.py:587-741, mpi_controller.cc:455-515). The weight
    arguments are over machines, in the JAX package's global form."""
    return _handles.synchronize(hierarchical_neighbor_allreduce_nonblocking(
        tensor, self_weight, neighbor_machine_weights, send_neighbor_machines,
        enable_topo_check, name))


def hierarchical_neighbor_allreduce_nonblocking(
    tensor,
    self_weight: Optional[Weights] = None,
    neighbor_machine_weights: Optional[NestedWeights] = None,
    send_neighbor_machines=None,
    enable_topo_check: bool = False,
    name: Optional[str] = None,
) -> int:
    _global_state().check_homogeneous()
    op_name = _auto_name("hierarchical_neighbor_allreduce", name)
    plan = _machine_plan(self_weight, neighbor_machine_weights,
                        send_neighbor_machines, enable_topo_check)
    with timeline_context(op_name, "HIERARCHICAL_NEIGHBOR_ALLREDUCE"):
        work, finish = hierarchical_start(plan, _as_list(tensor))
    return _handles.allocate(op_name, work,
                             lambda: _like(tensor, finish()))


# ---------------------------------------------------------------------------
# neighbor_allgather
# ---------------------------------------------------------------------------

def _gather_layout(topology, n: int):
    """Per shift s (the distinct ``(dst - src) % n`` of the edges), the
    slot of the source ``(dst - s) % n`` in ``dst``'s sorted in-neighbor
    list, or -1 where that edge does not exist: the port's copy of the
    shift/slot table of JAX ``windows._GraphLayout`` (:424-457)."""
    in_nbrs = {r: topology_util.in_neighbor_ranks(topology, r)
               for r in range(n)}
    shifts = sorted({(dst - src) % n for dst, srcs in in_nbrs.items()
                     for src in srcs})
    slot = np.full((len(shifts), n), -1, np.int64)
    for si, s in enumerate(shifts):
        for dst in range(n):
            src = (dst - s) % n
            if src in in_nbrs[dst]:
                slot[si, dst] = in_nbrs[dst].index(src)
    return in_nbrs, tuple(shifts), slot


def neighbor_allgather(tensor, name: Optional[str] = None):
    """This rank's in-neighbors' tensors concatenated along dim 0 in sorted
    in-neighbor rank order, self excluded (reference: mpi_ops.py:378-415;
    the MPI_Dist_graph ordering, torch/mpi_ops.cc:374-380). With no
    in-neighbor the result is ``[0, ...]``. On an irregular graph the ranks'
    results differ in length (JAX returns a per-rank list there)."""
    return _handles.synchronize(neighbor_allgather_nonblocking(tensor, name))


def neighbor_allgather_nonblocking(tensor, name: Optional[str] = None) -> int:
    st = _global_state()
    st.check_initialized()
    op_name = _auto_name("neighbor_allgather", name)
    n, me = st.size, st.rank
    xs = _as_list(tensor)
    for x in xs:
        if x.dim() < 1:
            raise ValueError(
                "neighbor_allgather concatenates per-rank tensors along their "
                f"first dimension, so each needs >= 1 dim; got "
                f"{tuple(x.shape)}")
    key = ("nag_layout",)
    layout = st._plan_cache.get(key)
    if layout is None:
        layout = st._plan_cache[key] = _gather_layout(st.topology, n)
    in_nbrs, shifts, slot = layout
    ops, outs = [], []
    with timeline_context(op_name, "NEIGHBOR_ALLGATHER"):
        for x in xs:
            x = x.contiguous()
            out = x.new_empty((len(in_nbrs[me]),) + tuple(x.shape))
            for si, s in enumerate(shifts):
                # rank i sends on shift s iff the edge (i, i+s) exists, and
                # j receives iff (j-s, j) does, so every send meets its
                # receive
                if slot[si, (me + s) % n] >= 0:
                    ops.append(dist.P2POp(dist.isend, x, (me + s) % n))
                if slot[si, me] >= 0:
                    ops.append(dist.P2POp(dist.irecv, out[slot[si, me]],
                                          (me - s) % n))
            outs.append(out.reshape((-1,) + tuple(x.shape[1:])))
        work = dist.batch_isend_irecv(ops) if ops else []
    return _handles.allocate(op_name, work, lambda: _like(tensor, outs))
