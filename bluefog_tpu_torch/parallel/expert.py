"""Switch mixture of experts: the dense single-device mode.

Counterpart of the dense part of ``bluefog_tpu/parallel/expert.py``:
``SwitchFFN`` with ``expert_axis=None`` (:84-95), top-1 (Switch) routing
that evaluates every expert on every token and selects with a one-hot,
and ``load_balance_loss`` (:136-141). The parameters keep flax's layout and
names (``gate [d, E]``, ``up [E, d, d_ff]``, ``down [E, d_ff, d]``, all
f32), so ``utils.interop.params_from_jax`` carries them across untransposed.

The expert-parallel mode (``switch_dispatch``, ``ep_apply``, ``ep_lm_*``:
two ``all_to_all`` hops per layer) runs only across ranks and is not ported
yet (ROADMAP Queue 1 item 5); ``expert_axis`` other than ``None`` raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime.state import resolve_device


class SwitchFFN(nn.Module):
    """Mixture-of-experts FFN, top-1 (Switch) routing, dense oracle.

    ``forward(x)`` takes ``[..., d_model]`` in any float dtype and returns
    the same shape and dtype; the products run in ``dtype``, the router's
    softmax in f32. Weights are drawn on ``device`` from ``seed`` (normal
    with std 1/sqrt(fan_in), fan_in the second-to-last axis as flax's
    ``lecun_normal``: ``d_model`` for ``gate`` and ``up``, ``d_ff`` for
    ``down``), or loaded with ``load_state_dict``.
    """

    def __init__(self, d_model: int, num_experts: int, d_ff: int,
                 dtype: torch.dtype = torch.float32,
                 expert_axis: Optional[str] = None, *, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        if expert_axis is not None:
            raise NotImplementedError(
                "the expert-parallel SwitchFFN (expert_axis set: all_to_all "
                "dispatch across ranks) is not ported yet (ROADMAP Queue 1 "
                "item 5); use expert_axis=None")
        dev = resolve_device(device)
        self.num_experts = num_experts
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=dev)
        self.gate = nn.Parameter(torch.empty(d_model, num_experts, **f32))
        self.up = nn.Parameter(torch.empty(num_experts, d_model, d_ff, **f32))
        self.down = nn.Parameter(
            torch.empty(num_experts, d_ff, d_model, **f32))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.reset_parameters(gen)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.gate, self.up, self.down):
            w.normal_(0.0, w.shape[-2] ** -0.5, generator=gen)

    def route(self, x: torch.Tensor):
        """Router probabilities ``[..., E]`` (f32) and the chosen expert of
        each token (the first maximum, as ``jnp.argmax``)."""
        probs = torch.softmax(
            (x.to(self.dtype) @ self.gate.to(self.dtype)).float(), dim=-1)
        return probs, probs.argmax(dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.to(self.dtype)
        probs, best = self.route(x)
        sel = F.one_hot(best, self.num_experts).to(self.dtype)
        h = torch.einsum("...d,edf->...ef", x, self.up.to(self.dtype))
        h = F.gelu(h, approximate="tanh")
        y = torch.einsum("...ef,efd->...ed", h, self.down.to(self.dtype))
        p_best = probs.amax(dim=-1).to(self.dtype)
        out = torch.einsum("...ed,...e->...d", y, sel) * p_best[..., None]
        return out.to(in_dtype)


def load_balance_loss(probs: torch.Tensor, best: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch aux loss: ``E * sum_e f_e * P_e`` (Fedus et al. 2021, eq. 4),
    with ``f_e`` the share of tokens routed to expert e and ``P_e`` the mean
    router probability of e."""
    f = F.one_hot(best, num_experts).float().reshape(-1, num_experts)
    pbar = probs.reshape(-1, num_experts).mean(dim=0)
    return num_experts * (f.mean(dim=0) * pbar).sum()
