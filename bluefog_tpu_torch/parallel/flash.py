"""Flash attention: hand-written CUDA kernels and their plain twins.

Counterpart of ``bluefog_tpu/parallel/flash.py``. Three kernels, each a
port of one Pallas TPU kernel, written in CUDA C++ for ``sm_90a``
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) and loaded through ctypes:

  * K1 ``flash_block`` -> ``bft_flash_fwd``: unnormalised attention
    partials ``(o, m, l)`` of q against one K/V block (``_kernel``, :79);
  * K2 ``flash_block_bwd`` pass 1 -> ``bft_flash_bwd_dq`` (``_dq_kernel``);
  * K3 ``flash_block_bwd`` pass 2 -> ``bft_flash_bwd_dkv`` (``_dkv_kernel``).

Each wrapper takes the kernel's PLAIN PyTorch version only when its tensors
lie on the CPU (the tests); on CUDA tensors it launches the kernel or
raises. ``launch_counts`` counts kernel launches, one per launch and
nowhere else, so a run can show that its path went through the kernels.

Layout is ``[B, S, H, D]`` throughout; m/l/d are ``[B, S, H]`` f32 (the TPU
kernels' lane-8 padding is gone). The kernels take bf16 q/k/v and D in
{64, 128}; the gradient ``g`` of the backward is f32, as ``_flash_bwd``
passes it. The backward kernels read it rounded to bf16 (exact on the main
path, where g is the widened cotangent of a bf16 output), with the row
stats packed per head (``_bwd_operands``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from . import _build

_NEG = -1e30
_HEAD_DIMS = (64, 128)
_LOG2E = 1.4426950408889634
_BWD_ROWS = 128    # the backward kernels' block rows (csrc/flash_bwd.cu)

launch_counts: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "bft_flash_fwd": [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P],
    "bft_flash_bwd_dq": [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P],
    "bft_flash_bwd_dkv": [_P] * 7 + [_I] * 8 + [ctypes.c_float, _P],
}


def _fn(lib_name: str, fn_name: str):
    fn = getattr(_build.load(lib_name), fn_name)
    fn.argtypes = _ARGTYPES[fn_name]
    fn.restype = ctypes.c_int
    return fn


def _on_cpu(*ts: torch.Tensor) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(
            f"flash inputs must all lie on the CPU or on one CUDA device, "
            f"got {sorted(str(t.device) for t in ts)}")
    return False


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} for the CUDA kernel, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for the CUDA kernel")


def _check_qkv(q, k, v) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D], got {tuple(q.shape)}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if D not in _HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernels take head dims "
                         f"{_HEAD_DIMS}, got {D}")
    if Sq < 1 or Sk < 1:
        raise ValueError("flash attention needs non-empty sequences")
    _check("q", q, torch.bfloat16, (B, Sq, H, D))
    _check("k", k, torch.bfloat16, (B, Sk, H, D))
    _check("v", v, torch.bfloat16, (B, Sk, H, D))
    return B, Sq, Sk, H, D


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def _allowed(Sq: int, Sk: int, q_off: int, k_off: int, device):
    q_pos = q_off + torch.arange(Sq, device=device)
    k_pos = k_off + torch.arange(Sk, device=device)
    return q_pos[:, None] >= k_pos[None, :]          # [Sq, Sk]


def flash_block_plain(q, k, v, q_off: int = 0, k_off: int = 0, *,
                      causal: bool = True):
    """Plain version of K1: dense masked scores, same cast points."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        allowed = _allowed(q.shape[1], k.shape[1], q_off, k_off, q.device)
        s = torch.where(allowed, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if causal:
        p = torch.where(allowed, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m.permute(0, 2, 1).contiguous(), l.permute(0, 2, 1).contiguous()


def _bwd_tiles_plain(q, k, v, g, d_term, m, l, q_off, k_off, causal):
    """The shared recompute of both backward passes (``_bwd_tiles``) over
    the whole block -> (g * inv_l, p_unnormalised, dS), scores [B, H, Sq, Sk].
    A row with l == 0 (no live key) gets inv_l = 0, as in the kernels."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - m.permute(0, 2, 1)[..., None])
    if causal:
        allowed = _allowed(q.shape[1], k.shape[1], q_off, k_off, q.device)
        p = torch.where(allowed, p, torch.zeros_like(p))
    inv_l = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))   # [B, Sq, H]
    g_scaled = (g.float() * inv_l[..., None]).to(g.dtype)
    dp = torch.einsum("bqhd,bkhd->bhqk", g_scaled.float(), v.float())
    ds = p * (dp - (d_term * inv_l).permute(0, 2, 1)[..., None])
    return g_scaled, p, ds


def flash_bwd_dq_plain(q, k, v, g, d_term, m, l, q_off: int = 0,
                       k_off: int = 0, *, causal: bool = True):
    """Plain version of K2: dq = dS . K * scale."""
    _, _, ds = _bwd_tiles_plain(q, k, v, g, d_term, m, l, q_off, k_off,
                                causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                        k.float()) * (1.0 / math.sqrt(q.shape[-1]))


def flash_bwd_dkv_plain(q, k, v, g, d_term, m, l, q_off: int = 0,
                        k_off: int = 0, *, causal: bool = True):
    """Plain version of K3: dv = p^T . (g inv_l), dk = dS^T . Q * scale."""
    g_scaled, p, ds = _bwd_tiles_plain(q, k, v, g, d_term, m, l, q_off,
                                       k_off, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(),
                      g_scaled.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * (1.0 / math.sqrt(q.shape[-1]))
    return dk, dv


def flash_block_bwd_plain(q, k, v, g, d_term, m, l, q_off: int = 0,
                          k_off: int = 0, *, causal: bool = True):
    """Plain version of K2 then K3 -> (dq, dk, dv)."""
    args = (q, k, v, g, d_term, m, l, q_off, k_off)
    dq = flash_bwd_dq_plain(*args, causal=causal)
    dk, dv = flash_bwd_dkv_plain(*args, causal=causal)
    return dq, dk, dv


def _blockwise_attention(q, k, v, causal: bool, tk: int):
    """Blockwise attention with an online softmax over K blocks of ``tk``:
    numerically the same function as the kernel, kept as an independent
    oracle for its values (the JAX package's ``_blockwise_attention``)."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qf = q.float() * scale
    q_pos = torch.arange(S, device=q.device)
    o = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, S, H), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, H), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, tk):
        kb = k[:, k0:k0 + tk].float()
        vb = v[:, k0:k0 + tk].float()
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kb)
        if causal:
            k_pos = k0 + torch.arange(kb.shape[1], device=q.device)
            allowed = (q_pos[None, :, None, None] >= k_pos[None, None, None, :])
            s = torch.where(allowed, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(allowed, p, torch.zeros_like(p))
        l = alpha * l + p.sum(dim=-1)
        o = alpha[..., None] * o + torch.einsum("bqhk,bkhd->bqhd", p, vb)
        m = m_new
    return (o / l[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def flash_block(q, k, v, q_off: int = 0, k_off: int = 0, *,
                causal: bool = True):
    """Attention partials of q against one K/V block (K1).

    q: [B, Sq, H, D]; k, v: [B, Sk, H, D]; q_off/k_off: global positions of
    element 0 (for causal masking across ring steps). Returns (o, m, l):
    [B, Sq, H, D] f32 unnormalised output and [B, Sq, H] f32 row max / row
    sum. The attention output is o / l.
    """
    if _on_cpu(q, k, v):
        return flash_block_plain(q, k, v, q_off, k_off, causal=causal)
    B, Sq, Sk, H, D = _check_qkv(q, k, v)
    o = torch.empty((B, Sq, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    err = _fn("flash_fwd", "bft_flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, Sq, Sk, H, D, int(q_off), int(k_off), int(causal),
        1.0 / math.sqrt(D), _stream(q))
    _raise_on(err, "bft_flash_fwd")
    launch_counts["flash_fwd"] += 1
    return o, m, l


def flash_block_bwd(q, k, v, g, d_term, m, l, q_off: int = 0, k_off: int = 0,
                    *, causal: bool = True):
    """Gradients of q's attention against one K/V block (K2 then K3).

    Inputs: q [B, Sq, H, D]; k, v [B, Sk, H, D]; g = dOut [B, Sq, H, D]
    (f32 for the kernels); ``d_term = sum(dOut * Out, -1)`` and the saved
    GLOBAL softmax stats ``m``, ``l``, all [B, Sq, H] f32. Returns
    (dq_partial, dk, dv) in f32.
    """
    args = (q, k, v, g, d_term, m, l)
    if _on_cpu(*args):
        return flash_block_bwd_plain(*args, q_off, k_off, causal=causal)
    ops = _bwd_operands(*args)
    return (_bwd_dq(q, k, v, ops, q_off, k_off, causal),
            *_bwd_dkv(q, k, v, ops, q_off, k_off, causal))


def _bwd_stats(d_term, m, l):
    """Row stats of the backward kernels, [B*H, Sq_pad, 2] f32 (lse2, d):
    lse2 = m*log2(e) + log2(l), so that P = exp2(s*scale*log2(e) - lse2) =
    exp(s*scale - m) / l. lse2 is +inf where l == 0 (inv_l = 0, ROADMAP
    Queue 3) and on the pad rows up to a multiple of the kernels' 128 block
    rows, so P is 0 there."""
    B, Sq, H = m.shape
    pad = -(-Sq // _BWD_ROWS) * _BWD_ROWS
    lse2 = torch.where(l > 0, m * _LOG2E + torch.log2(l),
                       torch.full_like(l, math.inf))
    stats = torch.empty((B, H, pad, 2), dtype=torch.float32, device=m.device)
    stats[:, :, :Sq, 0] = lse2.permute(0, 2, 1)
    stats[:, :, :Sq, 1] = d_term.permute(0, 2, 1)
    stats[:, :, Sq:, 0] = math.inf
    stats[:, :, Sq:, 1] = 0.0
    return stats


def _bwd_operands(q, k, v, g, d_term, m, l):
    """Checks the backward's operands and prepares what both kernels read:
    ((B, Sq, Sk, H, D), g in bf16, the packed row stats)."""
    B, Sq, Sk, H, D = _check_qkv(q, k, v)
    _check("g", g, torch.float32, (B, Sq, H, D))
    for name, t in (("d_term", d_term), ("m", m), ("l", l)):
        _check(name, t, torch.float32, (B, Sq, H))
    return (B, Sq, Sk, H, D), g.to(torch.bfloat16), _bwd_stats(d_term, m, l)


def _bwd_tail(shape, q, q_off, k_off, causal):
    B, Sq, Sk, H, D = shape
    return (B, Sq, Sk, H, D, int(q_off), int(k_off), int(causal),
            1.0 / math.sqrt(D), _stream(q))


def _bwd_dq(q, k, v, ops, q_off, k_off, causal):
    shape, g_b, stats = ops
    B, Sq, _, H, D = shape
    dq = torch.empty((B, Sq, H, D), dtype=torch.float32, device=q.device)
    err = _fn("flash_bwd", "bft_flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g_b.data_ptr(),
        stats.data_ptr(), dq.data_ptr(), *_bwd_tail(shape, q, q_off, k_off,
                                                     causal))
    _raise_on(err, "bft_flash_bwd_dq")
    launch_counts["flash_bwd_dq"] += 1
    return dq


def _bwd_dkv(q, k, v, ops, q_off, k_off, causal):
    shape, g_b, stats = ops
    B, _, Sk, H, D = shape
    dk = torch.empty((B, Sk, H, D), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, Sk, H, D), dtype=torch.float32, device=q.device)
    err = _fn("flash_bwd", "bft_flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g_b.data_ptr(),
        stats.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_bwd_tail(shape, q, q_off, k_off, causal))
    _raise_on(err, "bft_flash_bwd_dkv")
    launch_counts["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, g, d_term, m, l, q_off: int = 0, k_off: int = 0,
                 *, causal: bool = True):
    """Pass 1 of :func:`flash_block_bwd` (K2): dq in f32."""
    args = (q, k, v, g, d_term, m, l)
    if _on_cpu(*args):
        return flash_bwd_dq_plain(*args, q_off, k_off, causal=causal)
    return _bwd_dq(q, k, v, _bwd_operands(*args), q_off, k_off, causal)


def flash_bwd_dkv(q, k, v, g, d_term, m, l, q_off: int = 0, k_off: int = 0,
                  *, causal: bool = True):
    """Pass 2 of :func:`flash_block_bwd` (K3): (dk, dv) in f32."""
    args = (q, k, v, g, d_term, m, l)
    if _on_cpu(*args):
        return flash_bwd_dkv_plain(*args, q_off, k_off, causal=causal)
    return _bwd_dkv(q, k, v, _bwd_operands(*args), q_off, k_off, causal)


class _Flash(torch.autograd.Function):
    """flash_attention with the kernel backward (``_flash`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, m, l = flash_block(q, k, v, 0, 0, causal=causal)
        out = (o / l[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        gf = g.float().contiguous()
        d_term = (gf * out.float()).sum(dim=-1)
        dq, dk, dv = flash_block_bwd(q, k, v, gf, d_term, m, l, 0, 0,
                                     causal=ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(q, k, v, *, causal: bool = True):
    """Single-device flash attention over [B, S, H, D] (normalised output).

    Differentiable: the forward runs K1 and the backward K2 and K3, so
    neither direction materialises the [S, S] score tensor on the card.
    """
    return _Flash.apply(q, k, v, causal)
