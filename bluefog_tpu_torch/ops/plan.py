"""Combine plans: a weighted digraph compiled to point-to-point rounds.

Counterpart of ``bluefog_tpu/ops/plan.py`` (``CombinePlan`` :56-82,
``spmd_combine`` :85-116). The weighted digraph over ranks is decomposed
on the host into *circulant shifts*: edge set {(i, (i+s) mod n) : i} for
each distinct shift s, and rank j computes

    out[j] = W[j, j] * x[j] + sum_s W[(j-s) % n, j] * x[(j-s) % n]

Two strategies, chosen per graph by the same rule as the JAX package:

  * shifts: per shift ``s`` send to ``(me+s) % n`` and receive from
    ``(me-s) % n``, all shifts in one ``batch_isend_irecv``, and accumulate
    the weighted arrivals in shift order. Optimal for sparse graphs
    (Expo-2 has ceil(log2 n) shifts; a dynamic one-peer step has 1).
  * gather: one ``all_gather`` and a weighted sum with column ``me`` of W.
    Better for dense graphs where the shift count approaches n.

Sub-f32 inputs accumulate in f32: averaging is a convex combination and a
bf16 accumulator loses the consensus invariant. At n=1 there are no shifts
and the combine is ``1.0 * x`` through the same code.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import topology as topology_util


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype.is_floating_point and torch.finfo(dtype).bits < 32:
        return torch.float32
    return dtype


class CombinePlan:
    """Host-side decomposition of a combine matrix W (edge i->j = W[i,j])."""

    __slots__ = ("n", "shifts", "rows", "W", "use_gather")

    def __init__(self, W: np.ndarray,
                 force_gather: Optional[bool] = None) -> None:
        W = np.asarray(W, dtype=np.float32)
        n = W.shape[0]
        assert W.shape == (n, n), "combine matrix must be square"
        self.n = n
        self.W = W
        self.shifts = tuple(topology_util.shift_support(W))
        # rows[0, j] = self weight of rank j; rows[k+1, j] = weight rank j
        # applies to the value arriving over shift k.
        rows = np.zeros((len(self.shifts) + 1, n), dtype=np.float32)
        rows[0] = np.diag(W)
        for k, s in enumerate(self.shifts):
            rows[k + 1] = [W[(j - s) % n, j] for j in range(n)]
        self.rows = rows
        if force_gather is None:
            # all-gather moves (n-1) blocks; k shift rounds move k blocks.
            self.use_gather = len(self.shifts) >= max(4, n // 2)
        else:
            self.use_gather = force_gather

    def weight_array(self) -> np.ndarray:
        return self.W if self.use_gather else self.rows


def spmd_combine_start(w: np.ndarray, tensors: Sequence[torch.Tensor], *,
                       rank: int, n: int, shifts: Sequence[int],
                       use_gather: bool = False, group=None
                       ) -> Tuple[list, Callable[[], List[torch.Tensor]]]:
    """Issue the combine's transfers; returns ``(work, finish)``.

    ``w`` is the plan's weight array (``CombinePlan.weight_array()``):
    ``[k+1, n]`` rows for the shift strategy or the full ``[n, n]`` matrix
    for the gather strategy. ``rank`` and ``n`` are this process's rank and
    the size WITHIN ``group`` (default: the whole world); each transfer
    names its peer by global rank. Every rank of the group calls this with
    the same plan. Every shift's sends and receives go out in one
    ``batch_isend_irecv``, one receive buffer per shift. Once every ``Work``
    in ``work`` is waited on, ``finish()`` returns the new tensors; the
    inputs are not modified.
    """
    me = rank
    col = w[:, me]
    acc_ts = [_acc_dtype(x.dtype) for x in tensors]
    if use_gather:
        gathered, work = [], []
        for x in tensors:
            xs = [torch.empty_like(x) for _ in range(n)]
            work.append(dist.all_gather(xs, x.contiguous(), group=group,
                                        async_op=True))
            gathered.append(xs)

        def finish_gather() -> List[torch.Tensor]:
            outs = []
            for x, acc_t, xs in zip(tensors, acc_ts, gathered):
                acc = float(col[0]) * xs[0].to(acc_t)
                for i in range(1, n):
                    acc = acc + float(col[i]) * xs[i].to(acc_t)
                outs.append(acc.to(x.dtype))
            return outs

        return work, finish_gather
    sends = [x.contiguous() for x in tensors]
    recvs = [[torch.empty_like(x) for x in sends] for _ in shifts]
    ops = []
    for k, s in enumerate(shifts):
        dst = _global_rank(group, (me + s) % n)
        src = _global_rank(group, (me - s) % n)
        for x, r in zip(sends, recvs[k]):
            ops.append(dist.P2POp(dist.isend, x, dst, group=group))
            ops.append(dist.P2POp(dist.irecv, r, src, group=group))
    work = dist.batch_isend_irecv(ops) if ops else []

    def finish() -> List[torch.Tensor]:
        accs = [float(col[0]) * x.to(acc_t) for x, acc_t in zip(tensors,
                                                                  acc_ts)]
        for k in range(len(shifts)):
            wk = float(col[k + 1])
            accs = [a + wk * r.to(a.dtype) for a, r in zip(accs, recvs[k])]
        return [a.to(x.dtype) for a, x in zip(accs, tensors)]

    return work, finish


def _global_rank(group, r: int) -> int:
    """Rank ``r`` of ``group`` as a global rank, which ``P2POp`` takes."""
    return r if group is None else dist.get_global_rank(group, r)


def spmd_combine(w: np.ndarray, tensors: Sequence[torch.Tensor], *,
                 rank: int, n: int, shifts: Sequence[int],
                 use_gather: bool = False, group=None) -> List[torch.Tensor]:
    """Weighted neighbor combine of this rank's ``tensors``: the blocking
    form of :func:`spmd_combine_start` (same arguments)."""
    work, finish = spmd_combine_start(w, tensors, rank=rank, n=n,
                                      shifts=shifts, use_gather=use_gather,
                                      group=group)
    for req in work:
        req.wait()
    return finish()


def apply_plan(plan: CombinePlan, tensors: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Run ``plan`` on this rank's tensors over the default process group."""
    from ..runtime.state import _global_state

    st = _global_state()
    st.check_initialized()
    if plan.n != st.size:
        raise ValueError(f"plan is for {plan.n} ranks, runtime has {st.size}")
    return spmd_combine(plan.weight_array(), tensors, rank=st.rank, n=plan.n,
                        shifts=plan.shifts, use_gather=plan.use_gather)
