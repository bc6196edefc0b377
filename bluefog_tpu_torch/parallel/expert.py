"""Expert parallelism: Switch mixture of experts with all-to-all dispatch.

Counterpart of ``bluefog_tpu/parallel/expert.py``: ``SwitchFFN`` (:37-95),
``switch_dispatch`` (:98-133), ``load_balance_loss`` (:136-141),
``moe_param_specs`` (:162-178), ``ep_lm_init``/``ep_lm_apply``/
``ep_lm_loss_fn`` (:188-286), ``ep_place_params`` (:288-299) and
``ep_apply`` (:301-333). The parameters keep flax's layout and names
(``gate [d, E]``, ``up [E, d, d_ff]``, ``down [E, d_ff, d]``, all f32), so
``utils.interop.params_from_jax`` carries them across untransposed.

Two modes share one router:

  * ``expert_axis=None``: the dense single-device oracle, every expert on
    every token, selected with a one-hot;
  * ``expert_axis`` set: one expert per rank of ``group`` (default: the
    runtime's world), with ``up [1, d, d_ff]`` and ``down [1, d_ff, d]``
    this rank's expert and ``gate`` replicated. Each rank routes its own
    tokens: top-1 gate, each token's slot in its expert's buffer in token
    order, capacity ``ceil(capacity_factor * t / E)`` (later tokens beyond
    it are dropped: their output is exactly zero), one all-to-all to the
    experts' ranks, this rank's expert FFN, one all-to-all back, the
    combine scaled by the gate probability. The local steps
    (:func:`switch_send`, :func:`expert_ffn`, :func:`switch_combine`) carry
    no communication, so a virtual group can drive them in one process.

JAX runs every device in one ``shard_map``; the port runs one process per
rank, so each function takes this rank's tokens and returns this rank's
result. As in JAX's gradient of the mean of the ranks' losses, each rank's
loss term is its local loss over n: the replicated parameters' gradients
are summed over the ranks once (``_exchange._SumGrads``), and the expert
weights receive every rank's contribution through the backward of the
all-to-all, which is the same all-to-all. ``ep_mesh`` is absent: it builds
a JAX device mesh; ``group`` stands for ``(mesh, axis)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..runtime.state import _global_state, resolve_device
from ._exchange import (_all_to_all, _Exchange, _global_sum, _ring_group,
                        _summed_forward, _SumGrads)


def _check_layout(num_experts: int, n: int) -> None:
    if num_experts != n:
        raise ValueError(
            f"the model has {num_experts} experts but the expert group has "
            f"{n} ranks: one expert per rank is the supported layout")


class SwitchFFN(nn.Module):
    """Mixture-of-experts FFN, top-1 (Switch) routing.

    ``forward(x)`` takes ``[..., d_model]`` in any float dtype and returns
    the same shape and dtype; the products run in ``dtype``, the router's
    softmax in f32. Weights are drawn on ``device`` from ``seed`` (normal
    with std 1/sqrt(fan_in), fan_in the second-to-last axis as flax's
    ``lecun_normal``: ``d_model`` for ``gate`` and ``up``, ``d_ff`` for
    ``down``), or loaded with ``load_state_dict``.

    With ``expert_axis`` set (any name selects the mode, as in JAX) the
    module holds expert ``rank`` of ``group`` and must be built and called
    by every rank of ``group`` together, ``num_experts`` of them; the seeded
    draw is the dense twin's, of which it keeps its rank's expert. Each
    forward leaves this rank's Switch load-balance loss in ``moe_aux`` (JAX
    sows it into ``intermediates``; the ``ep_lm_*`` functions sum it).
    """

    def __init__(self, d_model: int, num_experts: int, d_ff: int,
                 dtype: torch.dtype = torch.float32,
                 expert_axis: Optional[str] = None,
                 capacity_factor: float = 2.0, *, group=None, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.num_experts = num_experts
        self.dtype = dtype
        self.expert_axis = expert_axis
        self.capacity_factor = capacity_factor
        self.group = group
        self.expert = None
        if expert_axis is not None:
            self.expert, n = _ring_group(group)
            _check_layout(num_experts, n)
        e_local = 1 if expert_axis is not None else num_experts
        f32 = dict(dtype=torch.float32, device=dev)
        self.gate = nn.Parameter(torch.empty(d_model, num_experts, **f32))
        self.up = nn.Parameter(torch.empty(e_local, d_model, d_ff, **f32))
        self.down = nn.Parameter(torch.empty(e_local, d_ff, d_model, **f32))
        self.moe_aux: Optional[torch.Tensor] = None
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.reset_parameters(gen)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw the dense twin's ``gate``, ``up`` and ``down`` from ``gen``;
        the expert-parallel module keeps its rank's expert of each."""
        for w in (self.gate, self.up, self.down):
            shape = w.shape if w is self.gate else \
                (self.num_experts, *w.shape[1:])
            full = torch.empty(shape, dtype=w.dtype, device=w.device)
            full.normal_(0.0, shape[-2] ** -0.5, generator=gen)
            if self.expert is not None and w is not self.gate:
                full = full[self.expert:self.expert + 1]
            w.copy_(full)

    def route(self, x: torch.Tensor):
        """Router probabilities ``[..., E]`` (f32) and the chosen expert of
        each token (the first maximum, as ``jnp.argmax``)."""
        probs = torch.softmax(
            (x.to(self.dtype) @ self.gate.to(self.dtype)).float(), dim=-1)
        return probs, probs.argmax(dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.expert_axis is not None:
            t = math.prod(x.shape[:-1])
            capacity = math.ceil(self.capacity_factor * t / self.num_experts)
            out, self.moe_aux = switch_dispatch(
                self.gate, self.up, self.down, x.reshape(t, x.shape[-1]),
                self.group, self.num_experts, capacity, self.dtype)
            return out.reshape(x.shape)
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


# ---------------------------------------------------------------------------
# the Switch dispatch: local steps and the two exchanges
# ---------------------------------------------------------------------------

def switch_send(gate: torch.Tensor, xt: torch.Tensor, num_experts: int,
                capacity: int, dtype: torch.dtype):
    """Route this rank's tokens ``xt [t, d]`` and fill the send buffer.

    Returns ``(send, disp, p_best, probs, best)``: ``send [E, C, d]`` holds
    expert e's tokens in ``send[e]``, token order, ``disp [t, E, C]`` the
    dispatch one-hots (token t in slot c of the buffer to e; a token beyond
    the capacity has none), ``p_best [t]`` each token's gate probability,
    and the f32 router probabilities and choices for the aux loss."""
    xt = xt.to(dtype)
    probs = torch.softmax((xt @ gate.to(dtype)).float(), dim=-1)
    best = probs.argmax(dim=-1)                              # [t]
    p_best = probs.amax(dim=-1).to(dtype)
    sel = F.one_hot(best, num_experts)                       # [t, E]
    # position of each token within its expert's send buffer
    pos = sel.cumsum(dim=0) * sel - 1                        # [t, E]
    keep = (pos < capacity) & (sel > 0)
    disp = keep[..., None] & (
        F.one_hot(pos.clamp(0, capacity - 1), capacity) > 0)
    disp = disp.to(dtype)                                    # [t, E, C]
    send = torch.einsum("tec,td->ecd", disp, xt)             # [E, C, d]
    return send, disp, p_best, probs, best


def expert_ffn(recv: torch.Tensor, up_local: torch.Tensor,
               down_local: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """This rank's expert over the buffers it received, ``recv [n, C, d]``
    (one per source rank): ``gelu(recv @ up) @ down`` in ``dtype``, gelu's
    tanh form as flax's ``nn.gelu``."""
    h = F.gelu(torch.einsum("ncd,df->ncf", recv, up_local[0].to(dtype)),
               approximate="tanh")
    return torch.einsum("ncf,fd->ncd", h, down_local[0].to(dtype))


def switch_combine(disp: torch.Tensor, back: torch.Tensor,
                   p_best: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Each token's expert output out of ``back [E, C, d]`` (the results
    returned from every expert), scaled by its gate probability, in
    ``dtype``; a dropped token's output is zero."""
    out = torch.einsum("tec,ecd->td", disp, back) * p_best[:, None]
    return out.to(dtype)


def _hop(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """One dispatch hop: ``x [E, C, d]``'s buffer j to rank j. It is its own
    inverse, so its backward is the same hop. The identity at n = 1."""
    if n == 1:
        return x
    hop = lambda t: _all_to_all(t, group)  # noqa: E731
    return _Exchange.apply(x, hop, hop)


def switch_dispatch(gate, up_local, down_local, xt: torch.Tensor, group,
                    num_experts: int, capacity: int, dtype):
    """The sparse Switch body for this rank: top-1 gate, capacity-bounded
    dispatch, all-to-all to the owning expert, FFN, all-to-all back.
    ``xt`` is this rank's tokens ``[t, d]``; ``up_local``/``down_local``
    are its expert's weights ``[1, d, d_ff]`` / ``[1, d_ff, d]``. Returns
    ``([t, d], aux)`` with ``aux`` this rank's load-balance loss. Shared by
    :func:`ep_apply` and the ``expert_axis`` mode of :class:`SwitchFFN`;
    every rank of ``group`` calls it together."""
    n = _ring_group(group)[1]
    send, disp, p_best, probs, best = switch_send(gate, xt, num_experts,
                                                  capacity, dtype)
    # tokens to their expert: rank e receives one [C, d] block per peer
    recv = _hop(send, n, group)
    y = expert_ffn(recv, up_local, down_local, dtype)
    # results back to the token-owning ranks
    back = _hop(y, n, group)
    out = switch_combine(disp, back, p_best, xt.dtype)
    return out, load_balance_loss(probs, best, num_experts)


def load_balance_loss(probs: torch.Tensor, best: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch aux loss: ``E * sum_e f_e * P_e`` (Fedus et al. 2021, eq. 4),
    with ``f_e`` the share of tokens routed to expert e and ``P_e`` the mean
    router probability of e."""
    f = F.one_hot(best, num_experts).float().reshape(-1, num_experts)
    pbar = probs.reshape(-1, num_experts).mean(dim=0)
    return num_experts * (f.mean(dim=0) * pbar).sum()


# ---------------------------------------------------------------------------
# a SwitchFFN's parameters on the ranks: ep_place_params and ep_apply
# ---------------------------------------------------------------------------

def _check_batches(shape, group, n: int) -> None:
    """JAX's "batch must divide the expert axis" on this rank's share: every
    rank holds an equal batch. One small all-gather of the shapes, skipped
    with the runtime's negotiate stage (``set_skip_negotiate_stage``)."""
    if _global_state().skip_negotiate or n == 1:
        return
    every: List = [None] * n
    dist.all_gather_object(every, tuple(shape), group=group)
    if any(e != tuple(shape) for e in every):
        total = sum(e[0] for e in every)
        raise ValueError(
            f"batch {total} must divide the expert axis size {n}: every "
            f"rank holds an equal share; got {[e[0] for e in every]}")


def ep_place_params(params: Mapping[str, torch.Tensor],
                    group=None) -> Dict[str, torch.Tensor]:
    """This rank's view of a :class:`SwitchFFN` param dict with the full
    ``[E, ...]`` experts: ``gate`` as it is (replicated), ``up`` and
    ``down`` sliced to this rank's expert ``[1, ...]`` (views, so a
    gradient reaches the rows of the full tensors)."""
    me, _ = _ring_group(group)
    return {"gate": params["gate"], "up": params["up"][me:me + 1],
            "down": params["down"][me:me + 1]}


def ep_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor,
             group=None, capacity_factor: float = 2.0,
             dtype: Optional[torch.dtype] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel SwitchFFN forward of this rank's tokens.

    ``params`` is a :class:`SwitchFFN` param dict (``gate``/``up``/``down``)
    with ``num_experts`` equal to the ranks of ``group`` (default: the
    runtime's world); ``x`` is this rank's ``[B/n, S, d]``, every rank's of
    the same shape. Returns this rank's ``(y, aux)``, ``aux`` its Switch
    load-balance loss (JAX returns every device's, ``[n]``). ``dtype`` is
    the compute dtype (default: ``x.dtype``).

    Capacity per expert and source rank is ``ceil(capacity_factor *
    local_tokens / num_experts)``; overflowed tokens get zero output.
    ``capacity_factor >= num_experts`` guarantees no drops. Differentiable:
    ``gate``'s gradient is summed over the ranks (it is replicated), and row
    ``rank`` of ``up`` and ``down`` receives every rank's tokens' gradient
    for this rank's expert; the other rows get none here.
    """
    me, n = _ring_group(group)
    if params["up"].shape[0] != n:
        raise ValueError(
            f"params have {params['up'].shape[0]} experts but the expert "
            f"group has {n} ranks")
    b, s, d = x.shape
    _check_batches(x.shape, group, n)
    capacity = math.ceil(capacity_factor * b * s / n)
    placed = ep_place_params(params, group)
    (gate,) = _SumGrads.apply(group, n, placed["gate"])
    out, aux = switch_dispatch(gate, placed["up"], placed["down"],
                               x.reshape(b * s, d), group, n, capacity,
                               dtype or x.dtype)
    return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# the expert-parallel MoE LM
# ---------------------------------------------------------------------------

def moe_param_specs(params: Mapping, axis: str = "expert"
                    ) -> Dict[str, Optional[str]]:
    """For each parameter name of a model containing :class:`SwitchFFN`
    submodules (a ``state_dict`` or ``named_parameters`` mapping), ``axis``
    for the expert-local ones and ``None`` for the replicated: JAX's
    PartitionSpec rule, ``up``/``down`` leaves of a SwitchFFN (named
    ``moe`` inside ``MoEBlock``). A dense FFN's ``up``/``down`` modules end
    in ``weight`` and stay replicated."""
    def spec(name: str) -> Optional[str]:
        keys = name.split(".")
        if keys[-1] in ("up", "down") and (
                "moe" in keys or any(k.startswith("SwitchFFN")
                                     for k in keys)):
            return axis
        return None
    return {name: spec(name) for name in params}


def _slice_experts(state: Mapping[str, torch.Tensor],
                   rank: int) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` with full ``[E, ...]`` experts -> the one of the
    expert-parallel model on ``rank``: each expert-local entry keeps
    expert ``rank`` alone."""
    specs = moe_param_specs(state)
    return {k: v[rank:rank + 1].clone() if specs[k] else v
            for k, v in state.items()}


def _switch_ffns(model) -> List[SwitchFFN]:
    return [m for m in model.modules() if isinstance(m, SwitchFFN)]


def _sum_aux(model) -> torch.Tensor:
    """The sum of the load-balance losses the last forward left in the MoE
    layers (JAX ``_sum_intermediates``), which it clears."""
    total = None
    for m in _switch_ffns(model):
        if m.moe_aux is not None:
            aux = m.moe_aux.float()
            total = aux if total is None else total + aux
            m.moe_aux = None
    if total is None:
        total = torch.zeros((), device=next(model.parameters()).device)
    return total


def _check_moe_model(model, group, axis: str) -> int:
    """JAX ``_check_moe_model``: the model's expert mode is ``axis`` over
    ``group``, one expert per rank. Returns n."""
    if model.expert_axis != axis:
        raise ValueError(f"model.expert_axis={model.expert_axis!r}; "
                         f"construct the model with expert_axis={axis!r}")
    _, n = _ring_group(group)
    moes = _switch_ffns(model)
    if any(m.group is not group for m in moes):
        raise ValueError("the model's MoE layers were built for another "
                         "process group; pass the same group")
    if moes:
        _check_layout(moes[0].num_experts, n)
    return n


def ep_lm_init(model, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Draw an ``expert_axis`` MoE model's parameters from ``seed`` through
    its dense twin (the same config with ``expert_axis=None``, which holds
    the full ``[E, ...]`` experts): ``model`` keeps this rank's experts, and
    the twin's full ``state_dict`` is returned (JAX returns the full params,
    which ``moe_param_specs`` then shards)."""
    from ..models.transformer import TransformerLM

    dev = model.embed.weight.device
    twin = TransformerLM(**dict(model.config, expert_axis=None),
                         device=dev, seed=seed)
    full = twin.state_dict()
    model.load_state_dict(_slice_experts(full, _switch_ffns(model)[0].expert))
    return full


def ep_lm_apply(model, tokens: torch.Tensor, group=None,
                axis: str = "expert") -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel forward of this rank's tokens ``[B/n, S]`` through
    an ``expert_axis=axis`` MoE LM: the batch and the experts ride the same
    ranks (DP+EP co-location); attention and dense blocks compute on the
    local batch, each MoE layer does its two all-to-all hops. Every rank of
    ``group`` calls it together. Returns this rank's ``(logits [B/n, S,
    V], aux)``, ``aux`` the summed Switch load-balance loss averaged over
    the ranks."""
    n = _check_moe_model(model, group, axis)
    _check_batches(tokens.shape, group, n)
    _sum_aux(model)                      # nothing stale from an earlier call
    logits = model(tokens)
    return logits, _global_sum(_sum_aux(model) / n, group, n)


def ep_lm_loss_fn(model, group=None, axis: str = "expert",
                  aux_weight: float = 0.01):
    """``loss_fn(model, (tokens, targets)) -> loss`` for the expert-parallel
    MoE LM: next-token cross-entropy plus ``aux_weight`` times the Switch
    load-balance loss, averaged over the ranks (JAX's mean of the
    devices' local losses). ``tokens``/``targets`` are this rank's ``[B/n,
    S]``. ``loss.backward()`` leaves JAX's gradient on every rank: the
    replicated parameters' summed over the ranks, this rank's experts'
    through the all-to-all; so a plain ``torch.optim`` step keeps the
    replicated parameters equal. Do not nest it in the decentralized
    optimizers: averaging parameters across ranks would mix different
    experts."""
    n = _check_moe_model(model, group, axis)

    def loss(model, batch) -> torch.Tensor:
        tokens, targets = batch
        _check_batches(tokens.shape, group, n)
        specs = moe_param_specs(dict(model.named_parameters()), axis)
        _sum_aux(model)
        logits = _summed_forward(model, group, n, (tokens,),
                                 keep=lambda name: specs[name] is None)
        logp = torch.log_softmax(logits.float(), dim=-1)
        ce = -logp.gather(-1, targets[..., None]).mean()
        return _global_sum((ce + aux_weight * _sum_aux(model)) / n, group, n)

    return loss
