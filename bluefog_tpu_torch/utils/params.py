"""Broadcast / average whole parameter sets and optimizer states.

Counterpart of ``bluefog_tpu/utils/params.py`` (:11-41), in the reference's
torch idiom (utility.py:22-160): the module's (or dict's, or iterable's, or
optimizer's) tensors are overwritten IN PLACE and the argument is returned.
"""

from __future__ import annotations

from typing import Iterable, List, Union

import torch
import torch.distributed as dist
from torch import nn

from ..ops import collectives as _collectives
from ..runtime.state import _global_state

Params = Union[nn.Module, dict, Iterable[torch.Tensor]]


def _tensors(params: Params) -> List[torch.Tensor]:
    if isinstance(params, nn.Module):
        return list(params.state_dict().values())
    if isinstance(params, dict):
        return list(params.values())
    return [p[1] if isinstance(p, tuple) else p for p in params]


def broadcast_parameters(params: Params, root_rank: int = 0) -> Params:
    """Overwrite every rank's values with ``root_rank``'s (the
    initial-state synchronization of decentralized training)."""
    ts = _tensors(params)
    outs = _collectives.broadcast(ts, root_rank)
    with torch.no_grad():
        for t, o in zip(ts, outs):
            t.copy_(o)
    return params


def allreduce_parameters(params: Params) -> Params:
    """Replace every rank's values with the global average."""
    ts = [t for t in _tensors(params) if t.is_floating_point()]
    outs = _collectives.allreduce(ts, average=True)
    with torch.no_grad():
        for t, o in zip(ts, outs):
            t.copy_(o)
    return params


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> torch.optim.Optimizer:
    """Overwrite every rank's optimizer state with ``root_rank``'s, in place.

    The root's layout (which parameters have state, each entry's shape and
    dtype, and its non-tensor values) is broadcast first, so a rank that
    has not stepped yet gets the entries allocated. The tensors then ride
    the parameters' device; one kept elsewhere (Adam's ``step`` lives on
    the CPU by default) is copied there and back. A state that is empty on
    the root raises ``ValueError`` rather than guessing at its layout.
    (JAX ``utils/params.py:31-41`` broadcasts the optax state pytree.)
    """
    st = _global_state()
    st.check_initialized()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    layout = None
    if st.rank == root_rank:
        layout = [{k: ("tensor", tuple(v.shape), v.dtype, v.device == p.device)
                   if torch.is_tensor(v) else ("value", v)
                   for k, v in optimizer.state[p].items()}
                  if p in optimizer.state else None for p in params]
    box = [layout]
    dist.broadcast_object_list(box, src=root_rank)
    layout = box[0]
    if not any(layout):
        raise ValueError(
            f"optimizer state is empty on root rank {root_rank}: step the "
            f"optimizer there before broadcasting its state")
    tensors = []
    for p, entries in zip(params, layout):
        if entries is None:
            optimizer.state.pop(p, None)
            continue
        state = optimizer.state[p]
        for k, (kind, *spec) in entries.items():
            if kind == "value":
                state[k] = spec[0]
                continue
            shape, dtype, on_param = spec
            t = state.get(k)
            if not (torch.is_tensor(t) and tuple(t.shape) == shape
                    and t.dtype == dtype):
                t = state[k] = torch.zeros(
                    shape, dtype=dtype,
                    device=p.device if on_param else "cpu")
            tensors.append(t)
    dev = params[0].device
    moved = [t if t.device == dev else t.to(dev) for t in tensors]
    _collectives.broadcast_(moved, root_rank)
    with torch.no_grad():
        for t, m in zip(tensors, moved):
            if m is not t:
                t.copy_(m)
    return optimizer
