"""Tensor parallelism for the transformer LM: Megatron over a model group.

Counterpart of ``bluefog_tpu/parallel/tensor.py``: ``LM_TP_RULES``
(:39-44), ``tp_shard_params`` (:64-86), ``tp_apply`` (:100-109) and
``tp_loss_fn`` (:112-136). JAX places each weight with a ``NamedSharding``
on a ``(data, model)`` mesh and lets XLA's partitioner insert the
all-reduces. The port runs one process per rank: each rank of the model
``group`` holds its slices and runs the Megatron forward explicitly:

  * ``qkv`` and ``up`` column-parallel (their output features), ``out``
    and ``down`` row-parallel (their input features): one all-reduce
    (:func:`~._exchange.model_reduce`) after each row-parallel product, two
    per block, and one :func:`~._exchange.model_copy` before each
    column-parallel product;
  * ``lm_head`` column-parallel (the vocabulary), ``embed`` feature-sharded,
    each followed by an all-gather of the last dim
    (:func:`~._exchange.model_gather`);
  * the norms replicated.

Rank r's ``qkv`` rows are the q, k and v rows of ITS heads (heads
``r*H/n .. (r+1)*H/n - 1``), not the r-th contiguous quarter of ``[3d, d]``:
each rank runs attention on its own heads. So attention shards only when
``num_heads % n == 0`` (JAX's layout hint shards the kernel whenever
``3d % n == 0``, the partitioner keeping the semantics); otherwise ``qkv``
and ``out`` stay replicated, as does any matching leaf whose dim does not
divide n. The forward reads the layout from the parameters' shapes.

The step functions (:func:`tp_block`, :func:`tp_logits`) take a list of
per-rank models and tensors: one entry, this process's share of ``group``;
or n entries, a virtual group of n ranks in one process. The data axis
(JAX's ``"data"``) is a second process group, ``data_group=`` of
:func:`tp_loss_fn`: the loss is the mean over the global batch and the
gradients are summed over it in the loss's backward. ``tp_mesh`` is absent:
it builds a JAX device mesh; ``group=`` stands for ``(mesh, "model")``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ._exchange import (_global_nll, _ring_group, _summed_forward,
                        model_copy, model_gather, model_reduce)

# dotted-name regex -> the sharded dim of the port's parameter (Dense
# weights are [out, in]: flax's P(None, "model") on an [in, out] kernel is
# dim 0 here; the embedding stays [vocab, d], dim 1)
LM_TP_RULES: Tuple[Tuple[str, int], ...] = (
    (r".*\.(qkv|up)\.weight$", 0),
    (r".*\.(out|down)\.weight$", 1),
    (r".*lm_head\.weight$", 0),
    (r".*embed\.weight$", 1),
)

_RULES = [(re.compile(pat), dim) for pat, dim in LM_TP_RULES]
_ATTENTION = re.compile(r".*\.(qkv|out)\.weight$")


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    mod_name, _, leaf = name.rpartition(".")
    return model.get_submodule(mod_name), leaf


def _heads(model: nn.Module, name: str) -> int:
    return model.get_submodule(name.rsplit(".", 2)[0]).num_heads


def shard_of(name: str, full: torch.Tensor, dim: int, me: int,
             n: int) -> torch.Tensor:
    """Rank ``me``'s slice of the dense parameter ``full`` along ``dim`` (a
    view): a contiguous 1/n, but for ``qkv``, whose dim 0 stacks q, k and
    v, rank ``me`` takes the same 1/n of each (the rows of its heads)."""
    if name.endswith("qkv.weight"):
        parts = full.unflatten(0, (3, full.shape[0] // 3))
        w = parts.shape[1] // n
        return parts[:, me * w:(me + 1) * w].flatten(0, 1)
    w = full.shape[dim] // n
    return full.narrow(dim, me * w, w)


def tp_layout(model: nn.Module, n: int) -> Dict[str, Optional[int]]:
    """For each parameter name of a dense ``TransformerLM``, the dim
    :func:`tp_shard_params` shards over a group of n ranks, or ``None``
    (replicated): the first matching ``LM_TP_RULES`` dim when it divides n,
    and for ``qkv``/``out`` only when the block's heads divide n."""
    layout = {}
    for name, p in model.named_parameters():
        dim = next((d for pat, d in _RULES if pat.match(name)), None)
        if dim is not None and (p.dim() <= dim or p.shape[dim] % n or (
                _ATTENTION.match(name) and _heads(model, name) % n)):
            dim = None
        layout[name] = dim
    return layout


@torch.no_grad()
def tp_shard_params(model: nn.Module, group=None) -> nn.Module:
    """Give ``model`` (a dense ``TransformerLM``: seeded, or loaded from
    ``utils.params_from_jax``) this rank's slices, in place, and return it.

    Each parameter that ``LM_TP_RULES`` shards (:func:`tp_layout`) becomes a new
    parameter holding this rank's slice (a copy: the dense tensor is
    released); the others stay as they are (replicated). Build the
    optimizer after this call. The model then runs through :func:`tp_apply`
    and :func:`tp_loss_fn` only: its own ``forward`` expects the dense
    shapes. Every rank of ``group`` (default: the runtime's world) calls it
    with the same dense parameters.
    """
    me, n = _ring_group(group)
    for name, dim in tp_layout(model, n).items():
        if dim is None:
            continue
        mod, leaf = _owner(model, name)
        full = getattr(mod, leaf)
        setattr(mod, leaf, nn.Parameter(
            shard_of(name, full, dim, me, n).clone(),
            requires_grad=full.requires_grad))
    model.tp_ranks = n
    return model


# ---------------------------------------------------------------------------
# the Megatron forward over a list of per-rank models
# ---------------------------------------------------------------------------

def _attention(block, h: torch.Tensor, positions: torch.Tensor):
    """``out(attn(qkv(h)))`` on the heads this rank's ``qkv`` holds (all of
    them when it is replicated): with ``out`` row-parallel, this rank's
    partial product."""
    from ..models.transformer import apply_rope

    B, S, _ = h.shape
    q, k, v = block.qkv(h).chunk(3, dim=-1)
    width = q.shape[-1]
    head_dim = block.out.weight.shape[0] // block.num_heads
    shape = (B, S, width // head_dim, head_dim)
    q, k, v = (t.reshape(shape) for t in (q, k, v))
    a = block.attn_fn(apply_rope(q, positions), apply_rope(k, positions), v)
    return block.out(a.reshape(B, S, width))


def _sublayer(xs, hs, fn, blocks, sharded: bool, group):
    """The residual ``x + fn(h)`` of each rank, the rank's ``fn`` a partial
    product summed over the group when the sublayer is sharded."""
    if sharded:
        hs = model_copy(hs, group)
    ys = [fn(b, h) for b, h in zip(blocks, hs)]
    if sharded:
        ys = model_reduce(ys, group)
    return [x + y for x, y in zip(xs, ys)]


def tp_block(blocks: List[nn.Module], xs: List[torch.Tensor],
             positions: torch.Tensor, d_ff: int,
             group=None) -> List[torch.Tensor]:
    """One transformer block on each rank of the list: the replicated
    residual stream ``xs`` in, out; attention and the MLP as Megatron's
    column- then row-parallel pair where the block's weights are sharded
    (read from their shapes against ``d_model`` and the dense ``d_ff``),
    each rank's full sublayer where they are replicated."""
    b0, d = blocks[0], xs[0].shape[-1]
    xs = _sublayer(xs, [b.RMSNorm_0(x) for b, x in zip(blocks, xs)],
                   lambda b, h: _attention(b, h, positions), blocks,
                   b0.qkv.weight.shape[0] < 3 * d, group)
    return _sublayer(xs, [b.RMSNorm_1(x) for b, x in zip(blocks, xs)],
                     lambda b, h: b.ffn(h), blocks,
                     b0.up.weight.shape[0] < d_ff, group)


def tp_logits(models: List[nn.Module], tokens: List[torch.Tensor],
              group=None) -> List[torch.Tensor]:
    """Each rank's f32 logits ``[B, S, V]`` over the full vocabulary, from
    its model's slices and its ``tokens [B, S]`` (the same tokens on every
    rank of a model group)."""
    m0 = models[0]
    cfg = m0.config
    positions = torch.arange(tokens[0].shape[1], device=tokens[0].device)
    xs = [m.embed(t) for m, t in zip(models, tokens)]
    if m0.embed.weight.shape[1] < cfg["d_model"]:
        xs = model_gather(xs, group)
    for i in range(m0.num_layers):
        xs = tp_block([getattr(m, f"block_{i}") for m in models], xs,
                      positions, cfg["d_ff"], group)
    hs = [m.final_norm(x) for m, x in zip(models, xs)]
    sharded = m0.lm_head.weight.shape[0] < cfg["vocab_size"]
    if sharded:
        hs = model_copy(hs, group)
    logits = [m.lm_head(h).float() for m, h in zip(models, hs)]
    return model_gather(logits, group) if sharded else logits


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _check_model(model: nn.Module, group) -> int:
    """n of ``group``, after checking that ``model`` was sharded over n
    ranks (or not at all: a dense model runs replicated)."""
    _, n = _ring_group(group)
    k = getattr(model, "tp_ranks", None)
    if k is not None and k != n:
        raise ValueError(f"the model's parameters were sharded over {k} "
                         f"ranks; the model group has {n}")
    return n


def tp_apply(model: nn.Module, tokens: torch.Tensor,
             group=None) -> torch.Tensor:
    """Tensor-parallel forward: this rank's f32 logits ``[B, S, V]`` over
    the full vocabulary (gathered over ``group``) for ``tokens [B, S]``,
    this data shard's batch, the same on every rank of the model group.
    ``model`` holds this rank's slices (:func:`tp_shard_params`); every
    rank of ``group`` (default: the runtime's world) calls it together."""
    _check_model(model, group)
    return tp_logits([model], [tokens], group)[0]


def tp_loss_fn(model: nn.Module, group=None, data_group=None):
    """``loss_fn(model, (tokens, targets)) -> loss`` under the TP layout.

    The mean next-token NLL over the global batch: ``tokens``/``targets``
    are this data shard's ``[B, S]``, the same on every rank of the model
    ``group``, and ``data_group`` (default: none, one data shard) holds one
    rank of each model group with the same slices. ``loss.backward()``
    leaves on each rank the gradient of its own slices (and the full
    gradient of the replicated parameters), summed over ``data_group``: JAX's
    ``jax.grad(tp_loss_fn(...))`` sliced to this rank, so a plain
    ``torch.optim`` step keeps the data replicas equal. Do not also wrap it
    in a data-parallel optimizer, which would average across model ranks
    holding different slices.
    """
    _check_model(model, group)
    n_data = 1 if data_group is None else dist.get_world_size(data_group)

    def loss(model, batch) -> torch.Tensor:
        tokens, targets = batch
        logits = _summed_forward(
            model, data_group, n_data, (tokens,),
            forward=lambda m, t: tp_apply(m, t, group))
        # the NLL sum over this shard's tokens over the global count: at one
        # data shard the bits of ``lm_loss`` (cross_entropy's mean)
        local = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                targets.reshape(-1), reduction="sum")
        return _global_nll(local, targets.numel(), data_group, n_data)

    return loss
