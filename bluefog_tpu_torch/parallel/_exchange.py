"""The exchanges that context, expert and tensor parallelism share.

  * :func:`_ring_group`: ``(me, n)`` of a process group, the runtime's
    world for ``None``;
  * :func:`_all_to_all`: chunk j of dim 0 to rank j, the chunks received in
    rank order (JAX's ``lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=True)``), over contiguous buffers;
  * :class:`_Exchange`: one exchange under autograd, whose backward is the
    inverse exchange (Ulysses's re-shards; the Switch dispatch's two hops,
    each its own inverse);
  * :class:`_SumGrads`: the identity on the replicated parameters whose
    backward sums their gradients over the ranks (the transpose of a ``P()``
    ``shard_map`` input), and :func:`_summed_forward`, a model's forward
    with its parameters passed through it;
  * :func:`_global_sum`: a per-rank value summed over the ranks, carrying
    the gradient of this rank's term alone (the losses of context, expert,
    tensor and pipeline parallelism);
  * Megatron's two operators and the vocabulary gather of tensor
    parallelism, each a function of a list of per-rank tensors:
    :func:`model_copy` (f: the identity whose backward all-reduces),
    :func:`model_reduce` (g: the all-reduce whose backward is the identity)
    and :func:`model_gather` (the all-gather over the last dim whose
    backward keeps this rank's slice). A list of one tensor is this
    process's share of ``group``; a list of n tensors is a virtual group
    of n ranks in one process (``chip_smoke.py`` drives one), which
    exchanges nothing.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.nn.utils.stateless import _reparametrize_module


def _ring_group(group) -> Tuple[int, int]:
    """``(me, n)`` of a group: the runtime's rank and size over the world,
    or this process's rank and size within ``group``."""
    if group is None:
        from ..runtime.state import _global_state

        st = _global_state()
        st.check_initialized()
        return st.rank, st.size
    return dist.get_rank(group), dist.get_world_size(group)


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


def _summed_forward(model, group, n: int, args: Sequence,
                    forward: Optional[Callable] = None,
                    keep: Optional[Callable[[str], bool]] = None):
    """``forward(model, *args)`` (default ``model(*args)``) with the
    model's trainable parameters, those ``keep(name)`` selects, passed
    through :class:`_SumGrads`: their gradients come out summed over the n
    ranks of ``group``. ``torch.func.functional_call`` with any forward."""
    names = [name for name, p in model.named_parameters()
             if p.requires_grad and (keep is None or keep(name))]
    summed = _SumGrads.apply(group, n, *(model.get_parameter(name)
                                         for name in names))
    with _reparametrize_module(model, dict(zip(names, summed)),
                               tie_weights=True):
        return model(*args) if forward is None else forward(model, *args)


def _global_sum(local: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum over the n ranks of ``group`` of each rank's ``local`` (one
    all-reduce of values), carrying the gradient of this rank's ``local``
    alone: the other ranks' terms reach the parameters through the
    exchanges and the replicated parameters' summed gradients."""
    if n == 1:
        return local
    total = local.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return local + (total - local).detach()


def _global_nll(local: torch.Tensor, count: int, group,
                n: int) -> torch.Tensor:
    """The NLL sum ``local`` over ``count`` tokens of each rank, summed over
    the ranks and divided by their total count, in one all-reduce."""
    totals = _global_sum(torch.stack([local, local.new_tensor(float(count))]),
                         group, n)
    return totals[0] / totals[1]


# ---------------------------------------------------------------------------
# tensor parallelism's collectives, over a list of per-rank tensors
# ---------------------------------------------------------------------------

def _sum(ts):
    return torch.stack(ts).sum(0) if len(ts) > 1 else ts[0]


class _Copy(torch.autograd.Function):
    """Megatron's f over a group: the identity forward, the all-reduce of
    the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """Megatron's g over a group: the all-reduce forward, the identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The all-gather of the last dim over a group, in rank order; the
    backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, me, n):
        ctx.me, ctx.w = me, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.me * ctx.w:(ctx.me + 1) * ctx.w], None, None, None


class _VirtualCopy(torch.autograd.Function):
    """f over a virtual group: every rank's gradient is the sum of all
    ranks'."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        live = [g for g in gs if g is not None]
        total = _sum(live) if live else None
        return tuple(total for _ in gs)


class _VirtualReduce(torch.autograd.Function):
    """g over a virtual group: every rank gets the sum; each rank's
    gradient is its own."""

    @staticmethod
    def forward(ctx, *xs):
        total = _sum(xs)
        return tuple(total.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        return gs


class _VirtualGather(torch.autograd.Function):
    """The all-gather of the last dim over a virtual group."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.w = xs[0].shape[-1]
        full = torch.cat(xs, dim=-1)
        return tuple(full.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        w = ctx.w
        return tuple(None if g is None else g[..., r * w:(r + 1) * w]
                     for r, g in enumerate(gs))


def model_copy(xs: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Megatron's f, before a column-parallel product: the identity on
    each rank's replicated input, whose backward sums the ranks' gradients
    (each rank's comes from its own columns)."""
    if len(xs) > 1:
        return list(_VirtualCopy.apply(*xs))
    if _ring_group(group)[1] == 1:
        return list(xs)
    return [_Copy.apply(xs[0], group)]


def model_reduce(xs: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Megatron's g, after a row-parallel product: the sum of the ranks'
    partial products on every rank; each rank's gradient passes through
    unchanged."""
    if len(xs) > 1:
        return list(_VirtualReduce.apply(*xs))
    if _ring_group(group)[1] == 1:
        return list(xs)
    return [_Reduce.apply(xs[0], group)]


def model_gather(xs: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The ranks' last-dim slices concatenated in rank order on every rank
    (the feature-sharded embedding, the vocab-sharded head); the backward
    keeps this rank's slice of the gradient."""
    if len(xs) > 1:
        return list(_VirtualGather.apply(*xs))
    me, n = _ring_group(group)
    if n == 1:
        return list(xs)
    return [_Gather.apply(xs[0], group, me, n)]
