"""Plain float32 reference of the decoder LM configurations.

Each layer as the configuration file states it, departures included:

  h = x + Wo . attn(rope(Wq . n1(x)), rope(Wk . n1(x)), Wv . n1(x))
  x' = h + Wdown . gelu_tanh(Wup . n2(h))

with n1, n2 RMS norms (``block.rms_norm_eps``, a learned scale), rotary
embedding over the whole head (first half paired with the second, base
``rotary_emb_base``), causal softmax attention scaled by 1/sqrt(head
size), no biases, an untied output head after a final RMS norm, and the
mean next-token cross-entropy of float32 logits.

It is computed in blocks so that it fits at the cells' sizes: every layer
is recomputed in the backward pass (``checkpoint``), and attention runs
over blocks of queries, each against the keys up to its end, each
recomputed as well.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import data, weights
from . import combine, lowp, train

Q_BLOCK = 1024


def param_specs(cfg: dict) -> List[weights.Spec]:
    d = int(cfg["hidden_size"])
    ff = int(cfg["intermediate_size"])
    V = int(cfg["vocab_size"])
    specs = [("embed", (V, d), ("normal", d ** -0.5))]
    for i in range(int(cfg["num_hidden_layers"])):
        specs += [
            (f"layers.{i}.norm1", (d,), ("ones",)),
            (f"layers.{i}.wqkv", (3 * d, d), ("normal", d ** -0.5)),
            (f"layers.{i}.wo", (d, d), ("normal", d ** -0.5)),
            (f"layers.{i}.norm2", (d,), ("ones",)),
            (f"layers.{i}.w_up", (ff, d), ("normal", d ** -0.5)),
            (f"layers.{i}.w_down", (d, ff), ("normal", ff ** -0.5)),
        ]
    specs += [("final_norm", (d,), ("ones",)),
              ("lm_head", (V, d), ("normal", d ** -0.5))]
    return specs


def _rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend_block(q, k, v, start: int, precision: str):
    """Queries ``q`` [B, H, Tq, D] at positions start.. against the keys
    and values [B, H, Tk, D] at positions 0.., causal."""
    s = lowp.matmul(q, k.transpose(-1, -2), precision) / math.sqrt(q.shape[-1])
    rows = torch.arange(start, start + q.shape[2], device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    s = s.masked_fill(cols > rows, float("-inf"))
    return lowp.matmul(torch.softmax(s, dim=-1), v, precision)


def _attention(q, k, v, precision: str):
    """Causal attention over [B, H, S, D] in blocks of queries."""
    out = []
    for start in range(0, q.shape[2], Q_BLOCK):
        end = min(start + Q_BLOCK, q.shape[2])
        out.append(checkpoint(_attend_block, q[:, :, start:end], k[:, :, :end],
                              v[:, :, :end], start, precision,
                              use_reentrant=False))
    return torch.cat(out, dim=2)


def _layer(x, norm1, wqkv, wo, norm2, w_up, w_down, cos, sin, cfg: dict,
           precision: str):
    B, S, d = x.shape
    H = int(cfg["num_attention_heads"])
    eps = float(cfg["block"]["rms_norm_eps"])
    qkv = lowp.linear(_rms_norm(x, norm1, eps), wqkv, precision)
    q, k, v = (t.reshape(B, S, H, d // H) for t in qkv.split(d, dim=-1))
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    a = _attention(*(t.transpose(1, 2) for t in (q, k, v)), precision)
    h = lowp.act(x + lowp.linear(a.transpose(1, 2).reshape(B, S, d), wo,
                                 precision), precision)
    u = lowp.linear(_rms_norm(h, norm2, eps), w_up, precision)
    return lowp.act(h + lowp.linear(F.gelu(u, approximate="tanh"), w_down,
                                    precision), precision)


def loss(W: Dict[str, torch.Tensor], batch, cfg: dict, precision: str):
    tokens, targets = batch
    S = tokens.shape[1]
    D = int(cfg["hidden_size"]) // int(cfg["num_attention_heads"])
    inv = float(cfg["rotary_emb_base"]) ** (
        -torch.arange(0, D // 2, device=tokens.device, dtype=torch.float32)
        / (D // 2))
    ang = torch.arange(S, device=tokens.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x = lowp.act(W["embed"][tokens], precision)
    for i in range(int(cfg["num_hidden_layers"])):
        leaves = [W[f"layers.{i}.{n}"] for n in
                  ("norm1", "wqkv", "wo", "norm2", "w_up", "w_down")]
        x = checkpoint(partial(_layer, cfg=cfg, precision=precision), x,
                       *leaves, cos, sin, use_reentrant=False)
    h = _rms_norm(x, W["final_norm"], float(cfg["block"]["rms_norm_eps"]))
    logits = lowp.linear(h, W["lm_head"], precision)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def readings(config: dict, job: dict, seed: int, device: torch.device,
             precision: str = "f32", steps: int = 3, rank: int = 0,
             world: int = 1) -> dict:
    """The reference's readings of ``steps`` steps of a cell from ``seed``,
    on ``rank`` of ``world``."""
    W = weights.generate(param_specs(config), seed, device)
    batches = data.make(config, job, seed, device, rank)[:steps]
    mean = combine.neighbour_mean(job["topology"], rank, world) \
        if world > 1 else None
    with train.strict_f32():
        return train.readings(
            partial(loss, cfg=config, precision=precision), W, batches,
            job["optimizer"], steps, mean)
