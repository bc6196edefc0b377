"""Classic collectives over the process group: allreduce, broadcast,
allgather, allgather_v, pair_gossip and barrier.

Counterpart of ``bluefog_tpu/ops/collectives.py`` (:62-397). Each process
passes its own tensor (or a list/tuple of tensors) and gets the
collective's result back as a new tensor (the JAX package's functional
contract; the inputs are not modified), except for the in-place ``_``
forms, which write the result into the input and return it, the
reference's semantics (mpi_ops.py:150-201). Sub-f32 floats are reduced in
f32, as the JAX ``_allreduce_fn`` does.

Every op has a ``*_nonblocking`` form that returns a handle for
``poll``/``synchronize``/``wait`` (``runtime/handles.py``); the blocking
form is ``synchronize(nonblocking(...))``, as in the JAX package. Each op's
issue is one timeline activity (``ALLREDUCE``, ``BROADCAST``, ...) under its
``name``, ``<op>.noname.<k>`` when none is given, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..runtime import handles as _handles
from ..runtime.state import _global_state
from ..runtime.timeline import timeline_context
from .neighbors import _auto_name
from .plan import _acc_dtype

TensorOrSeq = Union[torch.Tensor, Sequence[torch.Tensor]]

# the newer names where this torch has them (the older ones warn there)
_all_gather_flat = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _issue(name: str, activity: str, tensor: TensorOrSeq, one,
           into: bool = False) -> int:
    """Run ``one(x) -> (work, finish)`` on each tensor under the timeline
    activity ``activity`` of ``name`` and register one handle whose result
    has the structure of ``tensor``; with ``into`` the result is written
    into ``tensor``, which is returned."""
    single = isinstance(tensor, torch.Tensor)
    xs = [tensor] if single else list(tensor)
    with timeline_context(name, activity):
        parts = [one(x) for x in xs]
    work = [w for ws, _ in parts for w in ws]

    def finalize():
        outs = [finish() for _, finish in parts]
        if into:
            for x, o in zip(xs, outs):
                x.copy_(o)
            return tensor
        return outs[0] if single else type(tensor)(outs)

    return _handles.allocate(name, work, finalize)


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------

def allreduce(tensor: TensorOrSeq, average: bool = True,
              is_hierarchical_local: bool = False,
              name: Optional[str] = None):
    """Sum or average every rank's tensor; each rank gets the result.

    ``is_hierarchical_local`` restricts the reduction to this rank's machine
    (reference: allreduce on the LOCAL comm, mpi_controller.cc:138-160).
    """
    return _handles.synchronize(
        allreduce_nonblocking(tensor, average, is_hierarchical_local, name))


def allreduce_nonblocking(tensor: TensorOrSeq, average: bool = True,
                          is_hierarchical_local: bool = False,
                          name: Optional[str] = None) -> int:
    return _allreduce(tensor, average, is_hierarchical_local, name, False)


def allreduce_(tensor: TensorOrSeq, average: bool = True,
               is_hierarchical_local: bool = False,
               name: Optional[str] = None):
    """In-place :func:`allreduce`: writes the result into ``tensor``."""
    return _handles.synchronize(allreduce_nonblocking_(
        tensor, average, is_hierarchical_local, name))


def allreduce_nonblocking_(tensor: TensorOrSeq, average: bool = True,
                           is_hierarchical_local: bool = False,
                           name: Optional[str] = None) -> int:
    return _allreduce(tensor, average, is_hierarchical_local, name, True)


def _allreduce(tensor, average, is_hierarchical_local, name, into) -> int:
    st = _global_state()
    st.check_initialized()
    group, n = None, st.size
    if is_hierarchical_local:
        st.check_homogeneous()
        group, n = st.local_group, st.local_size

    def one(x: torch.Tensor):
        acc = x.to(_acc_dtype(x.dtype)).clone()
        work = dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group,
                               async_op=True)
        return [work], lambda: (acc / n if average else acc).to(x.dtype)

    return _issue(_auto_name("allreduce", name), "ALLREDUCE", tensor, one,
                  into)


# ---------------------------------------------------------------------------
# broadcast
# ---------------------------------------------------------------------------

def broadcast(tensor: TensorOrSeq, root_rank: int,
              name: Optional[str] = None):
    """Every rank receives rank ``root_rank``'s tensor."""
    return _handles.synchronize(broadcast_nonblocking(tensor, root_rank,
                                                      name))


def broadcast_nonblocking(tensor: TensorOrSeq, root_rank: int,
                          name: Optional[str] = None) -> int:
    return _broadcast(tensor, root_rank, name, False)


def broadcast_(tensor: TensorOrSeq, root_rank: int,
               name: Optional[str] = None):
    """In-place :func:`broadcast`: writes the result into ``tensor``."""
    return _handles.synchronize(broadcast_nonblocking_(tensor, root_rank,
                                                       name))


def broadcast_nonblocking_(tensor: TensorOrSeq, root_rank: int,
                           name: Optional[str] = None) -> int:
    return _broadcast(tensor, root_rank, name, True)


def _broadcast(tensor, root_rank, name, into) -> int:
    st = _global_state()
    st.check_initialized()
    if not 0 <= root_rank < st.size:
        raise ValueError(f"root_rank {root_rank} out of range [0, {st.size})")

    def one(x: torch.Tensor):
        out = x.contiguous().clone()
        return [dist.broadcast(out, src=root_rank, async_op=True)], \
            lambda: out

    return _issue(_auto_name("broadcast", name), "BROADCAST", tensor, one,
                  into)


# ---------------------------------------------------------------------------
# allgather / allgather_v
# ---------------------------------------------------------------------------

def _gather_meta(x: torch.Tensor) -> List[tuple]:
    """Every rank's ``(shape, dtype)``: one small all-gather."""
    metas: List = [None] * _global_state().size
    dist.all_gather_object(metas, (tuple(x.shape), x.dtype))
    return metas


def allgather(tensor: TensorOrSeq, name: Optional[str] = None):
    """Concatenate every rank's tensor along dim 0: ``[b, ...]`` on each of
    n ranks gives ``[n*b, ...]`` on every rank. Equal shapes are required,
    as in the JAX package; :func:`allgather_v` takes ragged first dims."""
    return _handles.synchronize(allgather_nonblocking(tensor, name))


def allgather_nonblocking(tensor: TensorOrSeq,
                          name: Optional[str] = None) -> int:
    st = _global_state()
    st.check_initialized()
    n = st.size

    def one(x: torch.Tensor):
        if not st.skip_negotiate:
            metas = _gather_meta(x)
            if any(m != metas[0] for m in metas):
                raise ValueError(
                    f"allgather needs equal shapes and dtypes on every rank "
                    f"(use allgather_v for ragged first dims); got {metas}")
        x = x.contiguous()
        shape = (n * x.shape[0],) + tuple(x.shape[1:]) if x.dim() else (n,)
        out = x.new_empty(shape)
        return [_all_gather_flat(out, x, async_op=True)], lambda: out

    return _issue(_auto_name("allgather", name), "ALLGATHER", tensor, one)


def allgather_v(tensor: TensorOrSeq, name: Optional[str] = None):
    """Concatenate every rank's tensor along dim 0 where the first dims may
    differ between ranks: every rank gets the same ``[sum_r b_r, ...]``.

    The reference gathers the sizes first, then runs MPI_Allgatherv
    (mpi_context.cc:443-508); here each rank's block is padded to the
    largest, one ``all_gather`` moves them and the padding is trimmed. The
    trailing shape and dtype must agree; that check runs even when the
    negotiate stage is skipped, since the sizes are gathered anyway.
    """
    return _handles.synchronize(allgather_v_nonblocking(tensor, name))


def allgather_v_nonblocking(tensor: TensorOrSeq,
                            name: Optional[str] = None) -> int:
    st = _global_state()
    st.check_initialized()

    def one(x: torch.Tensor):
        metas = _gather_meta(x)
        shape0, dtype0 = metas[0]
        for r, (shape, dtype) in enumerate(metas):
            if len(shape) < 1:
                raise ValueError(
                    f"allgather_v: rank {r} slice must have a first dim")
            if shape[1:] != shape0[1:] or dtype != dtype0:
                raise ValueError(
                    f"allgather_v: rank {r} slice {dtype}{shape} does not "
                    f"match rank 0's trailing shape {dtype0}"
                    f"{(-1,) + shape0[1:]}")
        sizes = [shape[0] for shape, _ in metas]
        b_max = max(sizes)
        if b_max == 0:
            return [], lambda: x.new_zeros((0,) + tuple(x.shape[1:]))
        block = x.new_zeros((b_max,) + tuple(x.shape[1:]))
        block[:x.shape[0]] = x
        out = x.new_empty((len(sizes) * b_max,) + tuple(x.shape[1:]))
        work = _all_gather_flat(out, block, async_op=True)
        return [work], lambda: torch.cat(
            [out[r * b_max:r * b_max + s] for r, s in enumerate(sizes)])

    return _issue(_auto_name("allgather_v", name), "ALLGATHER_V", tensor,
                  one)


# ---------------------------------------------------------------------------
# pair_gossip
# ---------------------------------------------------------------------------

def pair_gossip(tensor: TensorOrSeq,
                target_ranks: Union[Dict[int, int], Sequence[int]],
                self_weight: float = 0.5, pair_weight: float = 0.5,
                name: Optional[str] = None):
    """Exchange tensors within mutually paired ranks and combine:
    ``self_weight * x + pair_weight * x_peer`` in x's dtype.

    Reference: MPI_Sendrecv-based PairGossip (mpi_controller.cc:748-774).
    ``target_ranks`` (rank -> peer, every rank's) must be a symmetric
    pairing; a rank paired with itself keeps ``x`` as its peer's value.
    """
    return _handles.synchronize(pair_gossip_nonblocking(
        tensor, target_ranks, self_weight, pair_weight, name))


def pair_gossip_nonblocking(tensor: TensorOrSeq,
                            target_ranks: Union[Dict[int, int],
                                                Sequence[int]],
                            self_weight: float = 0.5,
                            pair_weight: float = 0.5,
                            name: Optional[str] = None) -> int:
    st = _global_state()
    st.check_initialized()
    n, me = st.size, st.rank
    if isinstance(target_ranks, dict):
        peers = [target_ranks.get(r, r) for r in range(n)]
    else:
        peers = list(target_ranks)
    if len(peers) != n:
        raise ValueError("target_ranks must give a peer for every rank")
    for r, p in enumerate(peers):
        if not 0 <= p < n:
            raise ValueError(f"peer {p} for rank {r} out of range")
        if peers[p] != r:
            raise ValueError(
                f"pair_gossip needs mutual pairs: rank {r} -> {p} but "
                f"rank {p} -> {peers[p]} (sendrecv semantics)")
    peer = peers[me]

    def one(x: torch.Tensor):
        x = x.contiguous()
        work, recv = [], x
        if peer != me:
            recv = torch.empty_like(x)
            work = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, peer),
                dist.P2POp(dist.irecv, recv, peer)])

        def finish():
            # JAX casts the weights to a float x's dtype (weak typing) and
            # rounds every op to that dtype; so does this
            sw, pw = self_weight, pair_weight
            if x.is_floating_point():
                sw, pw = (float(torch.tensor(v, dtype=x.dtype))
                          for v in (sw, pw))
            return (sw * x + pw * recv).to(x.dtype)

        return work, finish

    return _issue(_auto_name("pair_gossip", name), "PAIR_GOSSIP", tensor,
                  one)


# ---------------------------------------------------------------------------
# barrier
# ---------------------------------------------------------------------------

def barrier(name: Optional[str] = None) -> None:
    """Block until every rank arrives (and this rank's device work ends)."""
    del name
    st = _global_state()
    st.check_initialized()
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
        dist.barrier(device_ids=[st.device.index])
    else:
        dist.barrier()
