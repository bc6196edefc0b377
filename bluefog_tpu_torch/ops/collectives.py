"""Classic collectives over the process group: allreduce / broadcast /
barrier.

Counterpart of ``bluefog_tpu/ops/collectives.py`` (:62-300). Each process
passes its own tensor and gets the collective's result back as a new tensor
(the JAX package's functional contract; the inputs are not modified).
Sub-f32 floats are reduced in f32, as the JAX ``_allreduce_fn`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..runtime.state import _global_state
from .plan import _acc_dtype

TensorOrSeq = Union[torch.Tensor, Sequence[torch.Tensor]]


def _map(fn, tensor: TensorOrSeq):
    if isinstance(tensor, torch.Tensor):
        return fn(tensor)
    return type(tensor)(fn(t) for t in tensor)


def allreduce(tensor: TensorOrSeq, average: bool = True,
              is_hierarchical_local: bool = False,
              name: Optional[str] = None):
    """Sum or average every rank's tensor; each rank gets the result."""
    del name
    st = _global_state()
    st.check_initialized()
    if is_hierarchical_local:
        raise NotImplementedError(
            "hierarchical-local allreduce is not ported yet (ROADMAP Queue 1)")

    def one(x: torch.Tensor) -> torch.Tensor:
        acc = x.to(_acc_dtype(x.dtype)).clone()
        dist.all_reduce(acc, op=dist.ReduceOp.SUM)
        if average:
            acc = acc / st.size
        return acc.to(x.dtype)

    return _map(one, tensor)


def broadcast(tensor: TensorOrSeq, root_rank: int,
              name: Optional[str] = None):
    """Every rank receives rank ``root_rank``'s tensor."""
    del name
    st = _global_state()
    st.check_initialized()
    if not 0 <= root_rank < st.size:
        raise ValueError(f"root_rank {root_rank} out of range [0, {st.size})")

    def one(x: torch.Tensor) -> torch.Tensor:
        out = x.contiguous().clone()
        dist.broadcast(out, src=root_rank)
        return out

    return _map(one, tensor)


def barrier(name: Optional[str] = None) -> None:
    """Block until every rank arrives (and this rank's device work ends)."""
    del name
    st = _global_state()
    st.check_initialized()
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
        dist.barrier(device_ids=[st.device.index])
    else:
        dist.barrier()
