"""Combine plans: a weighted digraph compiled to point-to-point rounds.

Counterpart of ``bluefog_tpu/ops/plan.py`` (``CombinePlan`` :56-82,
``spmd_combine`` :85-116). The weighted digraph over ranks is decomposed
on the host into *circulant shifts*: edge set {(i, (i+s) mod n) : i} for
each distinct shift s, and rank j computes

    out[j] = W[j, j] * x[j] + sum_s W[(j-s) % n, j] * x[(j-s) % n]

Two strategies, chosen per graph by the same rule as the JAX package:

  * shifts: per shift ``s`` one ``batch_isend_irecv`` round — send to
    ``(me+s) % n``, receive from ``(me-s) % n`` — and accumulate the
    weighted arrival. Optimal for sparse graphs (Expo-2 has ceil(log2 n)
    shifts; a dynamic one-peer step has 1).
  * gather: one ``all_gather`` and a weighted sum with column ``me`` of W.
    Better for dense graphs where the shift count approaches n.

Sub-f32 inputs accumulate in f32: averaging is a convex combination and a
bf16 accumulator loses the consensus invariant. At n=1 there are no shifts
and the combine is ``1.0 * x`` through the same code.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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


def spmd_combine(w: np.ndarray, tensors: Sequence[torch.Tensor], *,
                 rank: int, n: int, shifts: Sequence[int],
                 use_gather: bool = False, group=None) -> List[torch.Tensor]:
    """Weighted neighbor combine of this rank's ``tensors``.

    ``w`` is the plan's weight array (``CombinePlan.weight_array()``):
    ``[k+1, n]`` rows for the shift strategy or the full ``[n, n]`` matrix
    for the gather strategy. Every rank calls this with the same plan.
    Returns new tensors; the inputs are not modified.
    """
    me = rank
    col = w[:, me]
    acc_ts = [_acc_dtype(x.dtype) for x in tensors]
    if use_gather:
        outs = []
        for x, acc_t in zip(tensors, acc_ts):
            xs = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(xs, x.contiguous(), group=group)
            acc = float(col[0]) * xs[0].to(acc_t)
            for i in range(1, n):
                acc = acc + float(col[i]) * xs[i].to(acc_t)
            outs.append(acc.to(x.dtype))
        return outs
    accs = [float(col[0]) * x.to(acc_t) for x, acc_t in zip(tensors, acc_ts)]
    sends = [x.contiguous() for x in tensors]
    for k, s in enumerate(shifts):
        dst, src = (me + s) % n, (me - s) % n
        recvs = [torch.empty_like(x) for x in sends]
        ops = []
        for x, r in zip(sends, recvs):
            ops.append(dist.P2POp(dist.isend, x, dst, group=group))
            ops.append(dist.P2POp(dist.irecv, r, src, group=group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        wk = float(col[k + 1])
        accs = [a + wk * r.to(a.dtype) for a, r in zip(accs, recvs)]
    return [a.to(x.dtype) for a, x in zip(accs, tensors)]


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
