"""The exchanges that context and expert parallelism share.

  * :func:`_all_to_all`: chunk j of dim 0 to rank j, the chunks received in
    rank order (JAX's ``lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=True)``), over contiguous buffers;
  * :class:`_Exchange`: one exchange under autograd, whose backward is the
    inverse exchange (Ulysses's re-shards; the Switch dispatch's two hops,
    each its own inverse);
  * :class:`_SumGrads`: the identity on the replicated parameters whose
    backward sums their gradients over the ranks (the transpose of a ``P()``
    ``shard_map`` input).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of dim 0 to rank j; returns the chunks received, in rank
    order. ``all_to_all_single`` reads and writes flat memory, so a
    permuted view is made contiguous first (its ``empty_like`` would keep
    the view's strides and scramble the layout)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _Exchange(torch.autograd.Function):
    """``fwd(x)`` forward and ``inverse(g)`` backward: an exchange whose
    transpose is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, fwd, inverse):
        ctx.inverse = inverse
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.inverse(g), None, None


class _SumGrads(torch.autograd.Function):
    """The identity on the parameters whose backward sums their gradients
    over the ranks of ``group`` in one fused all-reduce: JAX's transpose of
    a replicated (``P()``) ``shard_map`` input. It runs once, after every
    other node of the backward that reads the parameters, in the same place
    on every rank."""

    @staticmethod
    def forward(ctx, group, n, *params):
        ctx.group, ctx.n = group, n
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.n > 1:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.group)
            grads = [f.view_as(g) for f, g in
                     zip(flat.split([g.numel() for g in grads]), grads)]
        return (None, None, *grads)
