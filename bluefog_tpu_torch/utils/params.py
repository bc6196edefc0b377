"""Broadcast / average whole parameter sets across the ranks.

Counterpart of ``bluefog_tpu/utils/params.py`` (:11-30), in the reference's
torch idiom (utility.py:22-80): the module's (or dict's, or iterable's)
tensors are overwritten IN PLACE and the argument is returned.
"""

from __future__ import annotations

from typing import Iterable, List, Union

import torch
from torch import nn

from ..ops import collectives as _collectives

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
