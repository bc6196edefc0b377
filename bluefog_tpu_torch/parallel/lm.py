"""Context-parallel execution of the transformer LM, and the LM's training
loss without the ``[S, V]`` logits.

Counterpart of ``bluefog_tpu/parallel/lm.py``: ``cp_apply`` (:33-72),
``chunked_ce_loss`` (:75-115) and ``cp_loss_fn`` (:118-157).

``cp_apply`` runs a :class:`~bluefog_tpu_torch.models.TransformerLM` with the
sequence sharded over the ranks: each rank passes its ``S/n`` tokens, at
positions ``me*S/n + arange(S/n)``, attention runs as the einsum ring (or
Ulysses) with ``causal=True``, and every other layer (embed, RMSNorm, MLP,
head) is token-local. ``cp_loss_fn`` wraps it into the optimizer's
``loss_fn(model, batch)`` contract, with the mean cross-entropy over the
full sequence. As in JAX, where the replicated parameters' gradient is
summed over the mesh axis, every rank's parameters receive the gradient of
the full-sequence loss.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import partial
from typing import List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ._exchange import _global_nll, _ring_group, _summed_forward
from .context import (_check_shards, ring_attention_shard,
                      ulysses_attention_shard)


def _chunk_nll(h_c: torch.Tensor, t_c: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    logits = F.linear(h_c, w).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, t_c[:, None]).sum()


def chunked_ce_loss(model, tokens: torch.Tensor, targets: torch.Tensor,
                    chunk: int = 1024,
                    remat_backbone: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy WITHOUT materialising the logits.

    At long S the logits dominate memory and traffic: S=8192 x V=32768 in
    f32 is 1 GiB, with as much again for ``log_softmax`` and each of their
    gradients. This computes the backbone (``model.hidden``) once, then
    projects to the vocabulary ``chunk`` tokens at a time, each chunk under
    ``checkpoint``: the backward recomputes a chunk's ``[chunk, V]`` logits
    instead of keeping them, so peak logits memory falls from ``[S, V]`` to
    ``[chunk, V]``. The products run in the model's dtype and the softmax in
    f32, as the full-logits loss (``models.lm_loss``). ``remat_backbone``
    checkpoints the backbone too. ``model`` holds its parameters, so there
    is no ``params`` argument (the JAX function takes one).
    """
    t = tokens.numel()
    if t % chunk:
        raise ValueError(f"CE chunk {chunk} must divide the token count {t}")
    if remat_backbone:
        h = checkpoint(model.hidden, tokens, use_reentrant=False)
    else:
        h = model.hidden(tokens)
    # the [V, d] weight cast once, outside the chunk loop: inside it, every
    # chunk and every recompute in the backward would cast it again
    w = model.lm_head.weight.to(h.dtype)
    hc = h.reshape(t // chunk, chunk, h.shape[-1])
    tc = targets.reshape(t // chunk, chunk)
    totals = [checkpoint(_chunk_nll, hc[i], tc[i], w, use_reentrant=False)
              for i in range(t // chunk)]
    return torch.stack(totals).sum() / t


_CP_BODIES = {"ring": ring_attention_shard,
              "ulysses": ulysses_attention_shard}


def _cp_body(kind: str):
    if kind not in _CP_BODIES:
        raise ValueError(f"kind must be 'ring' or 'ulysses', got {kind!r}")
    return _CP_BODIES[kind]


def _blocks(model) -> List[torch.nn.Module]:
    return [getattr(model, f"block_{i}") for i in range(model.num_layers)]


@contextmanager
def _cp_model(model, kind: str, group):
    """``model`` with every block's ``attn_fn`` the ``kind`` body over
    ``group`` with ``causal=True`` (JAX ``_cp_model``, which clones the
    module), restored on exit. The autograd graph keeps the bodies it ran,
    so a backward after the exit runs the same ring."""
    body = partial(_cp_body(kind), causal=True, group=group)
    blocks = _blocks(model)
    saved = [b.attn_fn for b in blocks]
    for b in blocks:
        b.attn_fn = body
    try:
        yield model
    finally:
        for b, fn in zip(blocks, saved):
            b.attn_fn = fn


def _check_cp(model, tokens: torch.Tensor, kind: str, group) -> int:
    """JAX ``cp_apply``'s checks on this rank's token shard; returns n."""
    shape = (tokens.shape[0], tokens.shape[1], model.block_0.num_heads)
    return _check_shards(kind, group, q=shape)


def _positions(tokens: torch.Tensor, group) -> torch.Tensor:
    me, _ = _ring_group(group)
    sq = tokens.shape[1]
    return me * sq + torch.arange(sq, device=tokens.device)


def cp_apply(model, tokens: torch.Tensor, group=None,
             kind: str = "ring") -> torch.Tensor:
    """Sequence-parallel forward of this rank's tokens ``[B, S/n]`` ->
    this rank's logits ``[B, S/n, V]`` (f32); equal, to numerics, to the
    rows of ``model(tokens)`` over the full sequence. Every rank of
    ``group`` (default: the runtime's world) calls it together. ``model``
    holds its parameters, so there is no ``variables`` argument."""
    _check_cp(model, tokens, kind, group)
    with _cp_model(model, kind, group):
        return model(tokens, _positions(tokens, group))


def cp_loss_fn(model, group=None, kind: str = "ring"):
    """``loss_fn(model, (tokens, targets)) -> loss`` with CP attention.

    ``tokens`` and ``targets`` are this rank's ``[B, S/n]`` shards. The loss
    is the sum of the NLL over the full sequence divided by the global
    token count, the same value on every rank; ``loss.backward()`` leaves
    on every rank's parameters the gradient of that loss (the dense model's
    gradient), so a plain ``torch.optim`` step keeps the ranks' replicas
    equal. For one long-sequence replica: like JAX's, do not nest it in the
    data-parallel optimizers, which would average the equal gradients again
    (harmless) or combine the equal parameters (a no-op) at extra cost.
    Needs ``bf.init()`` (or ``group``) first; Ulysses checks ``model``'s
    heads against n here, as JAX checks them at the call.
    """
    _cp_body(kind)
    n = _ring_group(group)[1]
    if kind == "ulysses" and model.block_0.num_heads % n:
        raise ValueError(f"ulysses needs num_heads % {n} == 0; got "
                         f"{model.block_0.num_heads}")

    def loss(model, batch) -> torch.Tensor:
        tokens, targets = batch
        n = _check_cp(model, tokens, kind, group)
        with _cp_model(model, kind, group):
            logits = _summed_forward(model, group, n,
                                     (tokens, _positions(tokens, group)))
        logp = torch.log_softmax(logits, dim=-1)
        local = -logp.gather(-1, targets[..., None]).sum()
        # the full sequence's NLL sum over its token count: this rank's loss
        # carries the gradient of its own terms, and _SumGrads adds the
        # other ranks'
        return _global_nll(local, targets.numel(), group, n)

    return loss
