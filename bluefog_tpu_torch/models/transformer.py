"""Decoder-only transformer LM with pluggable attention.

Counterpart of ``bluefog_tpu/models/transformer.py`` (``apply_rope`` :26-37,
``_attention_sublayer`` :40-56, ``Block`` :59-76, ``MoEBlock`` :79-110,
``TransformerLM`` :113-170, ``MoETransformerLM`` :173-177). Module and
parameter names follow the flax tree (``embed``,
``block_<i>.{RMSNorm_0, qkv, out, RMSNorm_1, up, down}``, an MoE block's
``block_<i>.{RMSNorm_0, qkv, out, RMSNorm_1, moe.{gate, up, down}}``,
``final_norm``, ``lm_head``) so ``utils.interop.params_from_jax`` maps one
to the other.

Numerics follow flax, including its cast points:

  * ``Dense(dtype=bf16, param_dtype=f32)`` casts the input AND the f32
    weight to the compute dtype before the product;
  * ``RMSNorm`` (eps 1e-6) computes in f32 and casts to the compute dtype;
  * ``Embed`` returns rows of the table in the compute dtype;
  * ``nn.gelu`` is the tanh approximation;
  * RoPE is half-split (not interleaved) and computed in f32;
  * logits are cast to f32.

The Switch-MoE block (``parallel.expert.SwitchFFN``) runs in the dense
single-device mode, or with ``expert_axis`` set in the expert-parallel mode:
one expert per rank of ``group``, two all-to-all hops per MoE layer
(``parallel.ep_lm_loss_fn``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.context import reference_attention
from ..parallel.expert import SwitchFFN
from ..runtime.state import resolve_device


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over [B, S, H, D] with positions [S] or
    [B, S]."""
    d2 = x.shape[-1] // 2
    freqs = base ** (-torch.arange(0, d2, dtype=torch.float32,
                                   device=x.device) / d2)
    if positions.dim() == 1:
        positions = positions[None]
    ang = positions[..., None].float() * freqs           # [B, S, d2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        mul = torch.rsqrt(var + 1e-6) * self.scale
        return (xf * mul).to(self.dtype)


class Dense(nn.Module):
    """Bias-free dense layer: f32 weight [out, in], product in ``dtype``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype: torch.dtype,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(vocab, dim, dtype=torch.float32, device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        # a gather then a cast: the same values as gathering from the
        # table cast to ``dtype`` (flax), without casting the whole table
        return self.weight[tokens].to(self.dtype)


class _AttentionBlock(nn.Module):
    """The pre-norm attention residual that ``Block`` and ``MoEBlock`` share
    (``_attention_sublayer``), then the pre-norm FFN residual around the
    subclass's ``ffn``."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype,
                 attn_fn: Callable, device=None) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.attn_fn = attn_fn
        self.RMSNorm_0 = RMSNorm(d_model, dtype, device)
        self.qkv = Dense(d_model, 3 * d_model, dtype, device)
        self.out = Dense(d_model, d_model, dtype, device)
        self.RMSNorm_1 = RMSNorm(d_model, dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        B, S, d_model = x.shape
        h = self.RMSNorm_0(x)
        q, k, v = self.qkv(h).split(d_model, dim=-1)
        shape = (B, S, self.num_heads, d_model // self.num_heads)
        q, k, v = (t.reshape(shape) for t in (q, k, v))
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
        a = self.attn_fn(q, k, v).reshape(B, S, d_model)
        x = x + self.out(a)
        return x + self.ffn(self.RMSNorm_1(x))


class Block(_AttentionBlock):
    """Pre-norm attention + gelu FFN, each with a residual."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dtype: torch.dtype, attn_fn: Callable, device=None) -> None:
        super().__init__(d_model, num_heads, dtype, attn_fn, device)
        self.up = Dense(d_model, d_ff, dtype, device)
        self.down = Dense(d_ff, d_model, dtype, device)

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        return self.down(F.gelu(self.up(h), approximate="tanh"))


class MoEBlock(_AttentionBlock):
    """Transformer block whose FFN is a top-1 Switch mixture of experts
    (``SwitchFFN`` under the name ``moe``); attention as in ``Block``. With
    ``expert_axis`` set every rank of ``group`` builds and runs the block
    together (one expert per rank, ``ep_lm_loss_fn``); with ``None`` it is
    the dense oracle that runs anywhere."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 num_experts: int, dtype: torch.dtype, attn_fn: Callable,
                 expert_axis: Optional[str] = None,
                 capacity_factor: float = 2.0, device=None,
                 group=None) -> None:
        super().__init__(d_model, num_heads, dtype, attn_fn, device)
        self.moe = SwitchFFN(d_model, num_experts, d_ff, dtype, expert_axis,
                             capacity_factor, group=group, device=device)

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        return self.moe(h)


class TransformerLM(nn.Module):
    """Causal LM. ``attn_fn(q, k, v) -> out`` defaults to dense attention.

    ``num_experts > 0`` turns block i into an ``MoEBlock`` (Switch MoE FFN)
    when ``(i + 1) % moe_every == 0``. ``expert_axis`` selects the
    expert-parallel mode over ``group`` (default: the runtime's world), with
    ``capacity_factor`` bounding each expert's buffer; the dense mode takes
    ``capacity_factor`` for the JAX signature and ignores it.

    Weights are random, drawn on ``device`` from ``seed`` (normal with std
    1/sqrt(fan_in) for dense layers, the embedding and the experts, ones
    for norms; the expert-parallel model keeps its rank's experts of its
    dense twin's draw), or loaded with ``load_state_dict`` (e.g. from
    ``params_from_jax``). ``config`` holds the arguments but ``device``
    and ``seed``.
    """

    def __init__(self, vocab_size: int, num_layers: int = 2,
                 num_heads: int = 4, d_model: int = 128, d_ff: int = 512,
                 dtype: torch.dtype = torch.float32,
                 attn_fn: Optional[Callable] = None, num_experts: int = 0,
                 moe_every: int = 2, expert_axis: Optional[str] = None,
                 capacity_factor: float = 2.0, *, group=None, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.config = dict(
            vocab_size=vocab_size, num_layers=num_layers,
            num_heads=num_heads, d_model=d_model, d_ff=d_ff, dtype=dtype,
            attn_fn=attn_fn, num_experts=num_experts, moe_every=moe_every,
            expert_axis=expert_axis, capacity_factor=capacity_factor,
            group=group)
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.dtype = dtype
        self.expert_axis = expert_axis
        attn = attn_fn or partial(reference_attention, causal=True)
        self.embed = Embed(vocab_size, d_model, dtype, dev)
        for i in range(num_layers):
            if num_experts and (i + 1) % moe_every == 0:
                blk = MoEBlock(d_model, num_heads, d_ff, num_experts, dtype,
                               attn, expert_axis, capacity_factor, dev,
                               group)
            else:
                blk = Block(d_model, num_heads, d_ff, dtype, attn, dev)
            setattr(self, f"block_{i}", blk)
        self.final_norm = RMSNorm(d_model, dtype, dev)
        self.lm_head = Dense(d_model, vocab_size, dtype, dev)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.embed.weight.device)
        gen.manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (Dense, Embed)):
                fan_in = mod.weight.shape[1]
                mod.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
            elif isinstance(mod, SwitchFFN):
                mod.reset_parameters(gen)

    def hidden(self, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Backbone output [B, S, d_model] BEFORE the vocab projection."""
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.embed(tokens)
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, positions)
        return self.final_norm(x)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.lm_head(self.hidden(tokens, positions)).float()


def lm_loss(model: TransformerLM, batch) -> torch.Tensor:
    """Mean next-token softmax cross-entropy of ``batch = (tokens,
    targets)`` (the loss of ``scripts/lm_bench.py``)."""
    tokens, targets = batch
    logits = model(tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def MoETransformerLM(vocab_size: int, num_experts: int,
                     **kw) -> TransformerLM:
    """A ``TransformerLM`` with Switch-MoE FFN blocks (Fedus et al. 2021);
    see ``TransformerLM`` for the other arguments."""
    return TransformerLM(vocab_size=vocab_size, num_experts=num_experts, **kw)
