"""Three plain training steps and what the output check reads of them.

The readings, for ``steps`` steps on the first batches of the pool:

  * ``loss``: each step's loss;
  * ``grad``: each leaf's norm of the first step's gradient;
  * ``change``: each leaf's norm of its change over the steps;
  * ``weights``: the leaves of two or more dimensions.

Adam and SGD with momentum are written out here, as their papers and
``torch.optim``'s documentation state them (no weight decay, no dampening).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional

import torch

from ..check import leaf_norms


@contextlib.contextmanager
def strict_f32():
    """float32 products in float32: TF32 off for matmuls and cuDNN, and
    cuDNN's heuristics instead of its timed search, which a run that
    starts each shape once would pay for in full."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.backends.cudnn.benchmark, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = old[:3]
        torch.set_float32_matmul_precision(old[3])


@torch.no_grad()
def _update(opt: dict, W: Dict[str, torch.Tensor], state: dict, t: int) -> None:
    if opt["name"] == "adam":
        lr, (b1, b2), eps = opt["lr"], opt["betas"], opt["eps"]
        for name, p in W.items():
            g = p.grad
            m, v = state.setdefault(name, (torch.zeros_like(p),
                                           torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))
    elif opt["name"] == "sgd":
        lr, mu = opt["lr"], opt["momentum"]
        for name, p in W.items():
            if t == 1:
                state[name] = p.grad.clone()
            else:
                state[name].mul_(mu).add_(p.grad)
            p.add_(state[name], alpha=-lr)
    else:
        raise ValueError(f"unknown optimizer {opt['name']!r}")


def readings(loss_fn: Callable, W: Dict[str, torch.Tensor], batches: List,
             opt: dict, steps: int = 3,
             combine: Optional[Callable] = None) -> dict:
    """Train ``W`` in place for ``steps`` steps of ``loss_fn(W, batch)``,
    each update followed by ``combine(W)`` where a world has more than one
    rank (at one rank the combine is a mean over the rank alone)."""
    start = {n: p.detach().clone() for n, p in W.items()}
    for p in W.values():
        p.requires_grad_(True)
    losses, grad, state = [], {}, {}
    for t in range(1, steps + 1):
        for p in W.values():
            p.grad = None
        loss = loss_fn(W, batches[t - 1])
        loss.backward()
        losses.append(float(loss.detach()))
        if t == 1:
            grad = leaf_norms((n, p.grad) for n, p in W.items())
        _update(opt, W, state, t)
        if combine is not None:
            combine(W)
    change = leaf_norms((n, p.detach() - start.pop(n)) for n, p in W.items())
    return {"loss": losses, "grad": grad, "change": change,
            "weights": [n for n, p in W.items() if p.dim() >= 2]}
