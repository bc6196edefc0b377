"""Attention oracles for the parallel layer.

Counterpart of ``reference_attention`` in ``bluefog_tpu/parallel/context.py``
(:44-56): dense single-device attention over ``[B, S, H, D]``, computed in
f32 and cast back to the input dtype. It is the correctness oracle of the
tests and the transformer's default ``attn_fn``. Ring and Ulysses context
parallelism are a later slice of the port.
"""

from __future__ import annotations

import math

import torch

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
