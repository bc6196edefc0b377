"""Tensor fusion: pack many small tensors into one flat exchange buffer.

Counterpart of ``make_spec``/``pack``/``unpack`` in
``bluefog_tpu/ops/fusion.py`` (:40-96), the analog of BlueFog's fusion
buffer (reference: tensor_queue.cc:127-155). Optimizer-level parameter
averaging wants one send per shift over a single flat buffer instead of one
per parameter. The buffer takes the widest dtype of its tensors.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch


class PackSpec(NamedTuple):
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    total: int
    buffer_dtype: torch.dtype


def make_spec(tensors: Sequence[torch.Tensor]) -> PackSpec:
    shapes, dtypes, sizes, offsets = [], [], [], []
    off = 0
    buffer_dtype = None
    for t in tensors:
        shapes.append(tuple(t.shape))
        dtypes.append(t.dtype)
        sizes.append(t.numel())
        offsets.append(off)
        off += t.numel()
        buffer_dtype = t.dtype if buffer_dtype is None else \
            torch.promote_types(buffer_dtype, t.dtype)
    return PackSpec(tuple(shapes), tuple(dtypes), tuple(offsets),
                    tuple(sizes), off, buffer_dtype or torch.float32)


def pack(tensors: Sequence[torch.Tensor], spec: PackSpec) -> torch.Tensor:
    """Tensors -> one flat [total] buffer of ``spec.buffer_dtype``."""
    return torch.cat([t.reshape(-1).to(spec.buffer_dtype) for t in tensors])


def unpack(buffer: torch.Tensor, spec: PackSpec) -> List[torch.Tensor]:
    """Flat [total] buffer -> views/casts shaped like the packed tensors."""
    return [buffer[off:off + size].view(shape).to(dtype)
            for shape, dtype, off, size in zip(spec.shapes, spec.dtypes,
                                               spec.offsets, spec.sizes)]
