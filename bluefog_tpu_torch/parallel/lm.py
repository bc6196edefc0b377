"""The LM's training loss without the ``[S, V]`` logits.

Counterpart of ``chunked_ce_loss`` in ``bluefog_tpu/parallel/lm.py``
(:75-115). Context-parallel execution (``cp_apply``, ``cp_loss_fn``) runs
only across ranks and is a later slice (ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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
