"""Context parallelism: ring attention and Ulysses all-to-all attention.

Counterpart of ``bluefog_tpu/parallel/context.py``. The JAX package runs
every rank in one ``shard_map`` over the mesh's rank axis; the port runs
one process per rank, so each function here takes THIS rank's sequence
shard ``[B, S/n, H, D]`` and returns this rank's output shard. The ring is
the process group (default: the runtime's world); rank ``me`` holds
sequence positions ``[me*S/n, (me+1)*S/n)``.

  * Ring attention (Liu et al. 2023): K/V shards hop one rank forward per
    step (``i -> (i+1) % n``, one ``batch_isend_irecv`` round, as JAX's
    ``ppermute`` with ``perm``), so at step t rank ``me`` holds block
    ``(me - t) % n`` and folds it into an f32 online softmax
    (:func:`ring_forward_step`). The backward (:func:`ring_backward_step`)
    makes one more trip with the f32 dk/dv accumulators travelling beside
    their K/V block; the trip's last rotation brings them home. The einsum
    path computes each ``[S/n, S/n]`` block in f32; the flash path runs
    the CUDA kernels K1 (``flash_block``) and K2/K3 (``flash_block_bwd``)
    at the offsets ``(me*Sq, blk*Sk)``, and takes bf16 on the card.
  * Ulysses: an all-to-all re-shards sequence -> heads, dense attention
    (``reference_attention``) runs over the full sequence on H/n heads, and
    the inverse all-to-all re-shards back; the backward is the two
    all-to-alls in reverse (``_exchange._Exchange``).

At n = 1 every rotation and all-to-all is the identity and issues no
transfer. CPU tensors take the kernels' plain versions (no ``interpret``
argument); JAX's ``sequence_sharding`` and ``mesh_1d`` describe a device
mesh the port does not have.
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Sequence

import torch
import torch.distributed as dist

from ..ops.plan import _global_rank
from ._exchange import _all_to_all, _Exchange, _ring_group
from .flash import _allowed, flash_block, flash_block_bwd

_NEG = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Dense single-device attention; the correctness oracle."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(Sq, device=s.device)[:, None]
                >= torch.arange(Sk, device=s.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# the ring's per-step bodies (no communication)
# ---------------------------------------------------------------------------

def ring_forward_init(q: torch.Tensor):
    """The forward's f32 accumulators ``(o, m, l)`` before step 0: o
    ``[B, Sq, H, D]`` zeros, the row max m at ``-1e30`` and the row sum l
    at 0, both ``[B, Sq, H]`` (JAX's ``o0``, ``m0``, ``l0``)."""
    B, Sq, H, D = q.shape
    o = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sq, H), _NEG, dtype=torch.float32, device=q.device)
    return o, m, torch.zeros_like(m)


def ring_forward_step(q, kc, vc, state, q_off: int, k_off: int,
                      causal: bool, use_flash: bool):
    """Fold the K/V block ``(kc, vc)`` at global key offset ``k_off`` into
    the online softmax ``state = (o, m, l)`` of q at ``q_off``; returns the
    new state. The einsum body is JAX's ``_ring_einsum_partials`` step in
    f32 (PyTorch's default: no TF32); the flash body merges K1's partials
    of the block
    (``_ring_attention_flash``). A block wholly in q's future (causal)
    leaves the state as it was: its partials are m = -1e30, l = 0, o = 0."""
    o, m, l = state
    if use_flash:
        bo, bm, bl = flash_block(q, kc, vc, q_off, k_off, causal=causal)
        m_new = torch.maximum(m, bm)
        c_old = torch.exp(m - m_new)
        c_blk = torch.exp(bm - m_new)
        return (o * c_old[..., None] + bo * c_blk[..., None], m_new,
                l * c_old + bl * c_blk)
    # JAX's layout: scores [B, H, Sq, Sk], row stats [B, H, Sq]
    scale = 1.0 / math.sqrt(q.shape[-1])
    m_t = m.permute(0, 2, 1)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kc.float())
    if causal:
        masked = ~_allowed(q.shape[1], kc.shape[1], q_off, k_off, q.device)
        s.masked_fill_(masked, _NEG)
    m_new = torch.maximum(m_t, s.amax(dim=-1))
    p = s.sub_(m_new[..., None]).exp_()          # in place: s is not kept
    if causal:
        # a fully masked row must not count its masked scores
        p.masked_fill_(masked, 0.0)
    corr = torch.exp(m_t - m_new)
    l_new = l.permute(0, 2, 1) * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, vc.float())
    o_new = o * corr.permute(0, 2, 1)[..., None] + pv
    return o_new, m_new.permute(0, 2, 1), l_new.permute(0, 2, 1)


def ring_forward_finish(state, dtype: torch.dtype):
    """The normalised output ``o / l`` in ``dtype``, and the f32 row stats
    ``(m, l)`` the backward reconstructs the softmax from."""
    o, m, l = state
    return (o / l[..., None]).to(dtype), m.contiguous(), l.contiguous()


def ring_backward_init(q, k, v, out, m, l, g):
    """The backward's state before step 0: ``(dq, dk, dv, stats)`` with f32
    zero accumulators (JAX's ``dq0``, ``dk0``, ``dv0``) and the read-only
    ``stats = (g, d, m, l)``: the f32 cotangent of ``out``, the softmax
    projection ``d = sum(g * out, -1)``, and the saved row stats."""
    gf = g.float().contiguous()
    d_term = (gf * out.float()).sum(dim=-1)
    f32 = dict(dtype=torch.float32)
    return (torch.zeros(q.shape, device=q.device, **f32),
            torch.zeros(k.shape, device=k.device, **f32),
            torch.zeros(v.shape, device=v.device, **f32),
            (gf, d_term, m, l))


def ring_backward_step(q, kc, vc, state, q_off: int, k_off: int,
                       causal: bool, use_flash: bool):
    """Add the gradients of q's attention against the block ``(kc, vc)``
    at ``k_off`` to ``state = (dq, dkc, dvc, stats)``: dq stays with q,
    dkc/dvc are the block's travelling accumulators (JAX ``_ring_backward``'s
    ``block_grads_*`` and body). The flash body is K2 then K3."""
    dq, dkc, dvc, stats = state
    gf, d_term, m, l = stats
    if use_flash:
        dq_b, dk_b, dv_b = flash_block_bwd(q, kc, vc, gf, d_term, m, l,
                                           q_off, k_off, causal=causal)
        return dq + dq_b, dkc + dk_b, dvc + dv_b, stats
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float() * scale
    kf, vf = kc.float(), vc.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if causal:
        masked = ~_allowed(q.shape[1], kc.shape[1], q_off, k_off, q.device)
        s.masked_fill_(masked, _NEG)
    inv_l = 1.0 / l.permute(0, 2, 1)             # l > 0 on every live row
    p = s.sub_(m.permute(0, 2, 1)[..., None]).exp_().mul_(inv_l[..., None])
    if causal:
        p.masked_fill_(masked, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = dp.sub_(d_term.permute(0, 2, 1)[..., None]).mul_(p)
    return (dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale,
            dkc + torch.einsum("bhqk,bqhd->bkhd", ds, qf),  # qf holds scale
            dvc + torch.einsum("bhqk,bqhd->bkhd", p, gf), stats)


# ---------------------------------------------------------------------------
# the loop: rotations one rank forward
# ---------------------------------------------------------------------------

def _rotate(tensors: Sequence[torch.Tensor], me: int, n: int,
            group, step: int = 1) -> List[torch.Tensor]:
    """Send each tensor to rank ``(me + step) % n`` and receive its
    counterpart from ``(me - step) % n``: one ``batch_isend_irecv`` round
    (``ops/plan.py``'s pattern). The identity at n = 1."""
    if n == 1:
        return list(tensors)
    dst = _global_rank(group, (me + step) % n)
    src = _global_rank(group, (me - step) % n)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = []
    for x, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, x, dst, group=group))
        ops.append(dist.P2POp(dist.irecv, r, src, group=group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


def _ring_forward(q, k, v, causal: bool, use_flash: bool, me: int, n: int,
                  group):
    Sq, Sk = q.shape[1], k.shape[1]
    state = ring_forward_init(q)
    kc, vc = k, v
    for t in range(n):
        blk = (me - t) % n
        state = ring_forward_step(q, kc, vc, state, me * Sq, blk * Sk,
                                  causal, use_flash)
        if t < n - 1:   # the last rotation would bring K/V home unused
            kc, vc = _rotate((kc, vc), me, n, group)
    return ring_forward_finish(state, q.dtype)


def _ring_backward(q, k, v, out, m, l, g, causal: bool, use_flash: bool,
                   me: int, n: int, group):
    """One more trip of K/V with their f32 gradient accumulators; the
    trip's last rotation moves only dk/dv, which it brings home."""
    Sq, Sk = q.shape[1], k.shape[1]
    state = ring_backward_init(q, k, v, out, m, l, g)
    kc, vc = k, v
    for t in range(n):
        blk = (me - t) % n
        dq, dkc, dvc, stats = ring_backward_step(
            q, kc, vc, state, me * Sq, blk * Sk, causal, use_flash)
        if t < n - 1:
            kc, vc, dkc, dvc = _rotate((kc, vc, dkc, dvc), me, n, group)
        else:
            dkc, dvc = _rotate((dkc, dvc), me, n, group)
        state = (dq, dkc, dvc, stats)
    dq, dk, dv, _ = state
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingEinsum(torch.autograd.Function):
    """The einsum ring with the ring backward (``_ring_einsum_diff``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, me, n, group):
        out, m, l = _ring_forward(q, k, v, causal, False, me, n, group)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.ring = (causal, me, n, group)
        return out

    @staticmethod
    def backward(ctx, g):
        causal, me, n, group = ctx.ring
        grads = _ring_backward(*ctx.saved_tensors, g, causal, False, me, n,
                               group)
        return (*grads, None, None, None, None)


class _RingFlash(torch.autograd.Function):
    """The flash ring: K1 per step forward, K2 and K3 per step backward,
    on the same schedule as the einsum ring (``_ring_flash_diff``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, me, n, group):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, m, l = _ring_forward(q, k, v, causal, True, me, n, group)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.ring = (causal, me, n, group)
        return out

    @staticmethod
    def backward(ctx, g):
        causal, me, n, group = ctx.ring
        grads = _ring_backward(*ctx.saved_tensors, g, causal, True, me, n,
                               group)
        return (*grads, None, None, None, None)


def ring_attention_shard(q, k, v, *, causal: bool = False,
                         use_flash: bool = False, group=None):
    """Ring attention over this rank's shards ``q`` ``[B, Sq, H, D]`` and
    ``k``, ``v`` ``[B, Sk, H, D]``; returns this rank's output shard.

    Every rank of the ring (``group``, default the runtime's world) calls it
    together with equal shard shapes. ``use_flash`` computes each block
    with the CUDA kernels (bf16 on the card), else with f32 einsums.
    Differentiable (reverse mode) through the ring backward. With
    ``functools.partial`` it is a ``TransformerLM`` ``attn_fn``.
    """
    me, n = _ring_group(group)
    fn = _RingFlash if use_flash else _RingEinsum
    return fn.apply(q, k, v, causal, me, n, group)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

def _seq_to_heads(x, n: int, group):
    """``[B, S/n, H, D]`` shards -> ``[B, S, H/n, D]``: rank j keeps head
    group j of every rank's shard, in rank order along the sequence."""
    B, Sq, H, D = x.shape
    y = _all_to_all(x.reshape(B, Sq, n, H // n, D).permute(2, 0, 1, 3, 4),
                    group)
    return y.permute(1, 0, 2, 3, 4).reshape(B, n * Sq, H // n, D)


def _heads_to_seq(x, n: int, group):
    """The inverse of :func:`_seq_to_heads`."""
    B, S, Hn, D = x.shape
    y = _all_to_all(x.reshape(B, n, S // n, Hn, D).permute(1, 0, 2, 3, 4),
                    group)
    return y.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * Hn, D)


def ulysses_attention_shard(q, k, v, *, causal: bool = False, group=None):
    """Ulysses attention over this rank's shards ``[B, S/n, H, D]``;
    returns this rank's output shard. Needs ``H % n == 0``."""
    _, n = _ring_group(group)
    if n == 1:
        return reference_attention(q, k, v, causal=causal)
    to_heads = partial(_seq_to_heads, n=n, group=group)
    to_seq = partial(_heads_to_seq, n=n, group=group)
    q, k, v = (_Exchange.apply(x, to_heads, to_seq) for x in (q, k, v))
    out = reference_attention(q, k, v, causal=causal)
    return _Exchange.apply(out, to_seq, to_heads)


# ---------------------------------------------------------------------------
# checked entry points
# ---------------------------------------------------------------------------

def _check_shards(kind: str, group, **shapes) -> int:
    """JAX ``_cp_call``'s checks on shards: every rank's shapes agree (the
    global sequence is n equal shards) and, for Ulysses, the heads divide
    n. One small all-gather of the shapes, skipped with the runtime's
    negotiate stage (``set_skip_negotiate_stage``). Returns n."""
    from ..runtime.state import _global_state

    st = _global_state()
    st.check_initialized()
    me, n = _ring_group(group)
    mine = {name: tuple(s) for name, s in shapes.items()}
    if not st.skip_negotiate and n > 1:
        every: List = [None] * n
        dist.all_gather_object(every, mine, group=group)
        if any(e != mine for e in every):
            lens = {name: [e[name][1] for e in every] for name in mine}
            raise ValueError(
                f"sequence length must divide the ring size {n}: every rank "
                f"holds an equal shard; got shard lengths {lens}")
    heads = mine["q"][2]
    if kind == "ulysses" and heads % n:
        raise ValueError(f"ulysses needs heads % {n} == 0; got {heads} heads")
    return n


def ring_attention(q, k, v, group=None, causal: bool = False,
                   use_flash: bool = False):
    """:func:`ring_attention_shard` after JAX ``_cp_call``'s checks.

    ``q``, ``k``, ``v`` are this rank's shards; ``group`` (default: the
    runtime's world) stands for JAX's ``(mesh, axis)``."""
    _check_shards("ring", group, q=q.shape, k=k.shape, v=v.shape)
    return ring_attention_shard(q, k, v, causal=causal, use_flash=use_flash,
                                group=group)


def ulysses_attention(q, k, v, group=None, causal: bool = False):
    """:func:`ulysses_attention_shard` after JAX ``_cp_call``'s checks."""
    _check_shards("ulysses", group, q=q.shape, k=k.shape, v=v.shape)
    return ulysses_attention_shard(q, k, v, causal=causal, group=group)
