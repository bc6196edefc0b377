"""Pipeline parallelism: GPipe microbatching over the stages of a group.

Counterpart of ``bluefog_tpu/parallel/pipeline.py``: ``pp_stack_params``
(:54-79), ``pp_place_params`` (:195-197), the stage chunk with per-layer
recompute (``_chunk_applier``, :99-112), the GPipe tick schedule
(``_pp_fwd``, :115-182), the fused-loss schedule (``_pp_fused_loss``,
:204-317), ``pp_forward_fn``, ``pp_loss_fn``, ``pp_train_step_fn``,
``pp_train_init`` and ``pp_apply``.

Rank s of ``group`` (default: the runtime's world) is stage s and holds
the ``[1, per, ...]`` chunk of the stage-stacked blocks; embed, final norm
and LM head (``rest``) are replicated. The schedule runs M + S - 1 ticks
for M microbatches over S stages: at tick t stage s runs microbatch t - s
(stage 0 ingests it, the last stage records it), then every stage hands
its output to stage s + 1 in one ring shift (``context._rotate``'s
``batch_isend_irecv``). A stage skips the compute of its idle (bubble)
ticks, where JAX computes every tick and masks: the outputs are the same,
and each kernel launches M·L times per forward summed over the stages.

The whole schedule is one autograd Function (:class:`_GPipe`): its forward
keeps, for each microbatch, the stage's input and the graph of its layers,
each under ``torch.utils.checkpoint`` (JAX's per-layer
``jax.checkpoint``, so the backward recomputes each layer and K1 launches
once more); its backward runs the ticks in reverse with the gradient
handed back one stage per tick by explicit point-to-point transfers. No
autograd edge crosses processes, so a gradient that is never needed (the
wrap-around handoff stage 0 discards) cannot leave a sender waiting.

The schedule takes the list of stages this process runs and a
handoff: one stage and the ring shift over ``group``, or every stage of a
virtual pipeline in one process and a roll of the list
(``chip_smoke.py`` drives one). ``pp_mesh`` is absent: it builds a JAX
device mesh; ``group=`` stands for ``(mesh, "pipe")``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops.plan import _global_rank
from ._exchange import _global_sum, _ring_group, _SumGrads
from .context import _rotate

_REST = ("embed.weight", "final_norm.scale", "lm_head.weight")


def pp_stack_params(params: Mapping[str, torch.Tensor], n_stages: int
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """Split a ``TransformerLM`` state dict into (stage-stacked blocks,
    shared rest).

    ``block_<i>.<leaf>`` entries are stacked along a new leading stage axis
    as ``{leaf: [n_stages, layers_per_stage, ...]}`` (stage s holds blocks
    ``s*per .. (s+1)*per - 1`` in order); everything else (embed,
    final_norm, lm_head) is returned as it is."""
    blocks = sorted({k.split(".", 1)[0] for k in params
                     if k.startswith("block_")},
                    key=lambda k: int(k.split("_")[1]))
    n_layers = len(blocks)
    if n_layers == 0 or n_layers % n_stages:
        raise ValueError(
            f"num_layers {n_layers} must be a positive multiple of "
            f"n_stages {n_stages}")
    per = n_layers // n_stages
    leaves = [k.split(".", 1)[1] for k in params
              if k.startswith(blocks[0] + ".")]
    stacked = {}
    for leaf in leaves:
        layers = [params[f"{b}.{leaf}"] for b in blocks]
        stacked[leaf] = torch.stack(layers).reshape(
            (n_stages, per) + tuple(layers[0].shape))
    rest = {k: v for k, v in params.items() if not k.startswith("block_")}
    return stacked, rest


def pp_place_params(stacked: Mapping[str, torch.Tensor],
                    group=None) -> Dict[str, torch.Tensor]:
    """This rank's stage of a stage-stacked block dict: ``[1, per, ...]``
    views of the stacked tensors (so a gradient reaches their rows)."""
    me, _ = _ring_group(group)
    return {k: v[me:me + 1] for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# the GPipe tick schedule
# ---------------------------------------------------------------------------

def _layer(block, params: Dict[str, torch.Tensor], positions, h):
    return functional_call(block, params, (h, positions))


class _Stage:
    """Stage ``s``'s part of the schedule: its layers (callables ``h ->
    h``), stage 0's ``ingest(i)`` (microbatch i's input), the last stage's
    ``drain(i, y)`` (what it keeps of microbatch i's output), and per
    microbatch the input, output and drained value kept for the
    backward."""

    def __init__(self, s: int, layers: List[Callable],
                 ingest: Callable, drain: Callable) -> None:
        self.s, self.layers = s, layers
        self.ingest, self.drain = ingest, drain
        self.saved: Dict[int, tuple] = {}
        self.drained: List[torch.Tensor] = []


def _forward_tick(st: _Stage, t: int, x: Optional[torch.Tensor],
                  n_stages: int, n_micro: int,
                  grad: bool) -> Optional[torch.Tensor]:
    """Tick ``t`` of stage ``st``: microbatch ``t - s`` through its layers
    (each under ``checkpoint`` when ``grad``), from ``ingest`` on stage 0
    and from the received ``x`` elsewhere; the last stage drains it.
    Returns the output to hand on (``None`` on an idle tick)."""
    i = t - st.s
    if not 0 <= i < n_micro:
        return None
    if st.s == 0:
        x = st.ingest(i)
    elif grad:
        x = x.detach().requires_grad_()
    y = x
    for layer in st.layers:
        y = checkpoint(layer, y, use_reentrant=False) if grad else layer(y)
    out = st.drain(i, y) if st.s == n_stages - 1 else None
    if grad:
        st.saved[i] = (x, y, out)
    if out is not None:
        st.drained.append(out)
    return y.detach()


def _backward_tick(st: _Stage, t: int, g: Optional[torch.Tensor],
                   g_out: Optional[torch.Tensor], n_stages: int,
                   n_micro: int, fused: bool) -> Optional[torch.Tensor]:
    """Tick ``t`` of the backward on stage ``st``: the gradient of
    microbatch ``t - s``'s output (``g`` received from the next stage, or
    on the last stage its slice of ``g_out``, the gradient of the stage's
    output) through the stage's layers, recomputed. Returns the gradient of
    the stage's input to hand back (``None`` on stage 0, whose input came
    from ``ingest``, and on an idle tick)."""
    i = t - st.s
    if not 0 <= i < n_micro:
        return None
    x, y, out = st.saved.pop(i)
    if st.s == n_stages - 1:
        root, g = out, (g_out if fused else g_out[i])
    else:
        root = y
    torch.autograd.backward(root, g)
    return x.grad if st.s > 0 else None


class _GPipe(torch.autograd.Function):
    """The schedule under autograd: ``bind(leaves)`` builds the local
    stages from (detached copies of) the leaves, and the output of a stage
    that drains nothing (zeros); each other local stage's output is its
    microbatches' drained values stacked (``fused=False``) or summed
    (``fused=True``). The backward runs the ticks in reverse, handing each
    input's gradient back a stage per tick."""

    @staticmethod
    def forward(ctx, bind, handoff, n_stages, n_micro, fused, *leaves):
        grad = any(ctx.needs_input_grad[5:])
        ds = [leaf.detach().requires_grad_(leaf.requires_grad and grad)
              for leaf in leaves]
        with torch.set_grad_enabled(grad):
            stages, idle = bind(ds)
            xs: List = [None] * len(stages)
            ticks = n_micro + n_stages - 1
            for t in range(ticks):
                ys = [_forward_tick(st, t, x, n_stages, n_micro, grad)
                      for st, x in zip(stages, xs)]
                if t < ticks - 1:
                    xs = handoff(ys, 1)
        outs = []
        for st in stages:
            out = idle.clone()
            if st.drained:
                out = torch.stack(st.drained)
                out = (out.sum(0) if fused else out).detach()
            st.drained = []
            outs.append(out)
        ctx.run = (stages, handoff, n_stages, n_micro, fused, ds)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        stages, handoff, n_stages, n_micro, fused, ds = ctx.run
        del ctx.run
        recv: List = [None] * len(stages)
        for t in reversed(range(n_micro + n_stages - 1)):
            sends = [_backward_tick(st, t, g, g_out, n_stages, n_micro,
                                    fused)
                     for st, g, g_out in zip(stages, recv, gs)]
            if t > 0:
                recv = handoff(sends, -1)
        # zeros, not None, for a leaf this process's stages never read
        # (the embedding off stage 0, the head off the last stage): the
        # gradients' all-reduce after it must run on every rank
        return (None,) * 5 + tuple(
            d.grad if d.grad is not None or not d.requires_grad
            else torch.zeros_like(d) for d in ds)


def _stage_layers(model, stage: Mapping[str, torch.Tensor],
                  positions: torch.Tensor) -> List[Callable]:
    """The layers of a ``[1, per, ...]`` stage chunk, each a callable that
    runs ``model.block_0`` with one layer's parameters."""
    names = list(stage)
    per = stage[names[0]].shape[1]
    return [partial(_layer, model.block_0,
                    {k: stage[k][0, j] for k in names}, positions)
            for j in range(per)]


def _leaves(stages: Sequence[Mapping[str, torch.Tensor]]):
    return [t for st in stages for t in st.values()]


def _unflatten(stages, flat):
    it = iter(flat)
    return [{k: next(it) for k in st} for st in stages]


def pp_schedule(model, stages: Sequence[Mapping[str, torch.Tensor]],
                ids: Sequence[int], n_stages: int, handoff,
                mb_acts: torch.Tensor) -> List[torch.Tensor]:
    """The plain GPipe schedule of the stages ``ids`` this process runs
    (their ``[1, per, ...]`` chunks ``stages``) over ``mb_acts [M, mb, S,
    d]``, the embedded microbatches stage 0 ingests. Returns each local
    stage's ``[M, mb, S, d]`` outputs: the last stage's recorded
    microbatches, zeros on the others. ``handoff(xs, step)`` moves each
    local stage's entry of ``xs`` to stage ``s + step`` (an idle stage's
    entry is ``None``). Differentiable in the chunks and ``mb_acts``."""
    n_micro = mb_acts.shape[0]

    def bind(ds):
        *flat, mb = ds
        positions = torch.arange(mb.shape[2], device=mb.device)
        chunks = _unflatten(stages, flat)
        return ([_Stage(s, _stage_layers(model, c, positions),
                        lambda i, mb=mb: mb[i], lambda i, y: y)
                 for s, c in zip(ids, chunks)],
                torch.zeros_like(mb))

    return list(_GPipe.apply(bind, handoff, n_stages, n_micro, False,
                             *_leaves(stages), mb_acts))


def _module(mod, name: str, t: torch.Tensor, x):
    return functional_call(mod, {name: t}, (x,))


def _microbatch_loss(model, norm_w, head_w, y, targets):
    """Final norm, LM head and mean cross-entropy of one drained
    microbatch (JAX ``microbatch_loss``); under ``checkpoint`` its f32
    logits are recomputed in the backward, not kept."""
    h = _module(model.final_norm, "scale", norm_w, y)
    logits = _module(model.lm_head, "weight", head_w, h).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def pp_fused_schedule(model, stages: Sequence[Mapping[str, torch.Tensor]],
                      ids: Sequence[int], n_stages: int, handoff,
                      rest: Mapping[str, torch.Tensor],
                      tokens_mb: torch.Tensor,
                      targets_mb: torch.Tensor) -> List[torch.Tensor]:
    """The fused-loss schedule (JAX ``_pp_fused_loss``): stage 0 embeds
    microbatch i of ``tokens_mb [M, mb, S]`` inside its tick, the last
    stage folds each drained microbatch into its cross-entropy against
    ``targets_mb`` at once, so a stage keeps one ``[mb, S, d]`` boundary
    activation per microbatch and never a batch's logits. Returns each
    local stage's sum of its microbatches' mean losses (0 on all but the
    last). Differentiable in the chunks and ``rest``."""
    n_micro = tokens_mb.shape[0]
    seq = tokens_mb.shape[2]

    def bind(ds):
        *flat, emb, norm_w, head_w = ds
        positions = torch.arange(seq, device=emb.device)
        chunks = _unflatten(stages, flat)

        def ingest(i):
            return _module(model.embed, "weight", emb, tokens_mb[i])

        def drain(i, y):
            return checkpoint(partial(_microbatch_loss, model), norm_w,
                              head_w, y, targets_mb[i], use_reentrant=False)

        return ([_Stage(s, _stage_layers(model, c, positions), ingest,
                        drain) for s, c in zip(ids, chunks)],
                torch.zeros((), device=emb.device))

    return list(_GPipe.apply(bind, handoff, n_stages, n_micro, True,
                             *_leaves(stages),
                             *(rest[k] for k in _REST)))


def virtual_handoff(xs: List, step: int) -> List:
    """The handoff of a virtual pipeline that runs every stage in one
    process: stage s's entry to stage ``s + step``, as a roll of the
    list."""
    n = len(xs)
    return [xs[(s - step) % n] for s in range(n)]


def _ring_handoff(me: int, n: int, group, like: torch.Tensor):
    """The handoff over ``group``: one ring shift of this stage's entry
    (zeros on an idle tick, the shape of ``like``)."""
    def handoff(xs: List, step: int) -> List:
        x = xs[0] if xs[0] is not None else torch.zeros_like(like)
        return _rotate([x], me, n, group, step)

    return handoff


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank of ``group`` (JAX's masked
    ``psum`` of the recorded outputs). The backward is the identity: every
    rank's gradient is the same, and only the last stage's is read, so the
    broadcast does not scale it by n."""

    @staticmethod
    def forward(ctx, x, group, n):
        x = x.clone()
        if n > 1:
            dist.broadcast(x, src=_global_rank(group, n - 1), group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _check_micro(b: int, n_micro: int) -> None:
    if b % n_micro:
        raise ValueError(
            f"batch {b} must divide into {n_micro} microbatches")


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def pp_forward_fn(model, group=None, n_micro: int = 2):
    """The pipelined forward ``fwd(stage, rest, tokens) -> logits``.

    ``stage`` is this rank's ``[1, per, ...]`` chunk
    (:func:`pp_stack_params` + :func:`pp_place_params`, once), ``rest`` the
    replicated embed/final_norm/lm_head dict, ``tokens [B, S]`` the whole
    batch on every rank. Returns the f32 logits ``[B, S, V]`` on every rank
    of ``group`` (default: the runtime's world), which all call it together.
    ``model`` gives the structure (``block_0``, ``embed``, ``final_norm``,
    ``lm_head``, run with the given parameters); its own parameters are not
    read, so a one-layer model of the same widths will do."""
    me, n = _ring_group(group)

    def fwd(stage, rest, tokens):
        b, seq = tokens.shape
        _check_micro(b, n_micro)
        # every stage embeds the batch (JAX's replicated prologue); only
        # stage 0's use reaches the table, so its gradient is summed
        (emb,) = _SumGrads.apply(group, n, rest["embed.weight"])
        x = _module(model.embed, "weight", emb, tokens)
        mb = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
        handoff = _ring_handoff(me, n, group, mb[0])
        (out,) = pp_schedule(model, [stage], [me], n, handoff, mb)
        x = _FromLast.apply(out, group, n).reshape(b, seq, x.shape[-1])
        x = _module(model.final_norm, "scale", rest["final_norm.scale"], x)
        return _module(model.lm_head, "weight", rest["lm_head.weight"],
                       x).float()

    return fwd


def pp_loss_fn(model, group=None, n_micro: int = 2):
    """``loss(stage, rest, (tokens, targets)) -> scalar``: the mean
    next-token cross-entropy of :func:`pp_forward_fn`'s logits, the same
    value on every rank. ``backward()`` leaves each rank the gradient of its
    stage chunk and the full gradient of ``rest``."""
    fwd = pp_forward_fn(model, group, n_micro)

    def loss(stage, rest, batch):
        tokens, targets = batch
        logits = fwd(stage, rest, tokens)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))

    return loss


def _pp_fused_loss(model, group=None, n_micro: int = 2):
    """The loss of :func:`pp_loss_fn` through :func:`pp_fused_schedule`:
    the same value and gradients, with no stage keeping a batch's
    activations or logits. ``rest``'s gradient comes from stage 0 (embed)
    and the last stage (final_norm, lm_head) and is summed over ``group``."""
    me, n = _ring_group(group)

    def loss(stage, rest, batch):
        tokens, targets = batch
        b, seq = tokens.shape
        _check_micro(b, n_micro)
        mb = b // n_micro
        summed = dict(zip(_REST, _SumGrads.apply(
            group, n, *(rest[k] for k in _REST))))
        d = rest["embed.weight"].shape[1]
        like = torch.zeros((mb, seq, d), dtype=model.dtype,
                           device=tokens.device)
        (part,) = pp_fused_schedule(
            model, [stage], [me], n, _ring_handoff(me, n, group, like),
            summed, tokens.reshape(n_micro, mb, seq),
            targets.reshape(n_micro, mb, seq))
        return _global_sum(part, group, n) / n_micro

    return loss


def pp_train_init(model, group, params: Mapping[str, torch.Tensor],
                  optimizer: Callable):
    """``(stage, rest, opt)`` for :func:`pp_train_step_fn` from a plain
    ``TransformerLM`` state dict: this rank's stage chunk and the rest as
    fresh leaf tensors (copies: the step never writes the caller's
    tensors), and ``opt = optimizer(params)`` over them, e.g.
    ``optimizer=functools.partial(torch.optim.Adam, lr=1e-2)``."""
    _, n = _ring_group(group)
    stacked, rest = pp_stack_params(params, n)
    stage = {k: v.detach().clone().requires_grad_()
             for k, v in pp_place_params(stacked, group).items()}
    rest = {k: v.detach().clone().requires_grad_() for k, v in rest.items()}
    return stage, rest, optimizer([*stage.values(), *rest.values()])


def pp_train_step_fn(model, group, optimizer, n_micro: int = 2,
                     fused_loss: bool = False):
    """The pipelined training step ``step(stage, rest, batch) -> loss``.

    ``optimizer`` is the ``torch.optim`` optimizer over ``stage`` and
    ``rest`` (:func:`pp_train_init`); the step zeroes its gradients, runs
    the loss's forward and backward through the whole GPipe schedule (the
    loss averages over the microbatches, so its gradient is the accumulated
    per-microbatch gradient) and steps it, in place. ``fused_loss`` takes
    :func:`_pp_fused_loss`, the same numerics with no stage keeping a
    batch's activations or logits."""
    loss_fn = (_pp_fused_loss if fused_loss else pp_loss_fn)(
        model, group, n_micro)

    def step(stage, rest, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(stage, rest, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def pp_apply(model, params: Mapping[str, torch.Tensor],
             tokens: torch.Tensor, group=None,
             n_micro: int = 2) -> torch.Tensor:
    """One-shot pipelined forward of a plain ``TransformerLM`` state dict
    (stacked and placed on every call; for training loops use
    :func:`pp_forward_fn` with a placed stage)."""
    _, n = _ring_group(group)
    stacked, rest = pp_stack_params(params, n)
    return pp_forward_fn(model, group, n_micro)(
        pp_place_params(stacked, group), rest, tokens)
