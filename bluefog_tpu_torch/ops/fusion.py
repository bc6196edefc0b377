"""Tensor fusion: pack many small tensors into one flat exchange buffer.

Counterpart of ``make_spec``/``pack``/``unpack`` in
``bluefog_tpu/ops/fusion.py`` (:40-96), the analog of BlueFog's fusion
buffer (reference: tensor_queue.cc:127-155). Optimizer-level parameter
averaging wants one send per shift over a single flat buffer instead of one
per parameter. The buffer takes the widest dtype of its tensors.

The host-side row functions (``pack_row``/``unpack_row``/``assemble_rows``,
JAX ``fusion.py:98-203``) work on ONE rank's row in numpy, for the
one-sided paths that move a row between controllers as host bytes (the
hosted window plane, rejoin state transfer). A ``codec`` of ``ops/codec.py``
encodes or decodes the row on the way. Host rows of bfloat16 are ``uint16``
bit patterns (``codec.BF16``). ``assemble_rows`` reads a spec's ``shard``
table (a ``ShardSpec``-like value: ``factor``, ``pieces``, ``row_len``),
which the sharded window plane builds.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .codec import BF16, cast


class PackSpec(NamedTuple):
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    total: int
    buffer_dtype: torch.dtype
    # resolved shard partition (factor, pieces, totals, row_len) or None
    shard: Optional[Any] = None


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


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a host row of ``dtype`` is held in (bf16: ``BF16``)."""
    if dtype == torch.bfloat16:
        return BF16
    return torch.empty((), dtype=dtype).numpy().dtype


def to_host(t) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array; bf16 as its
    ``uint16`` bit patterns."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(BF16)
    return t.cpu().numpy()


def from_host(arr: np.ndarray, dtype: torch.dtype,
              device=None) -> torch.Tensor:
    """Inverse of :func:`to_host`: a host array as a ``dtype`` tensor of
    its own (never sharing ``arr``'s memory), on ``device``."""
    arr = np.ascontiguousarray(arr)
    if dtype == torch.bfloat16:
        t = torch.from_numpy(cast(arr, BF16).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(cast(arr, host_dtype(dtype)))
    if device is None or torch.device(device).type == "cpu":
        return t.clone()
    return t.to(device)


def _piece_shape(shape: Tuple[int, ...], piece) -> Tuple[int, ...]:
    """The sub-array shape one shard piece ``(leaf, axis, a, b)`` selects."""
    _, ax, a, b = piece
    if ax < 0:
        return shape
    return shape[:ax] + (b - a,) + shape[ax + 1:]


def unpack_row(row, spec: PackSpec, codec=None) -> List[np.ndarray]:
    """ONE rank's flat ``[total]`` row -> per-leaf host arrays.

    ``codec``: ``row`` is an encoded wire payload; it is decoded back to
    the flat buffer-dtype row first (the inverse of :func:`pack_row`'s
    encode)."""
    bt = host_dtype(spec.buffer_dtype)
    if codec is not None:
        row = codec.decode(np.asarray(row).reshape(-1).view(np.uint8), bt,
                           spec.total)
    row = to_host(row).reshape(-1)
    return [cast(row[off:off + size].reshape(shape), host_dtype(dtype))
            for shape, dtype, off, size in zip(spec.shapes, spec.dtypes,
                                               spec.offsets, spec.sizes)]


def pack_row(leaf_rows: Sequence, spec: PackSpec, codec=None,
             shard: Optional[int] = None) -> np.ndarray:
    """Per-leaf arrays of ONE rank -> its flat ``[total]`` host row in the
    buffer dtype (the host inverse of :func:`unpack_row`).

    ``codec``: also encode the row into the codec's uint8 payload.
    ``shard`` (sharded specs only): pack shard ``shard``'s pieces instead,
    zero-padded to ``spec.shard.row_len`` so every shard frames to one
    window shape."""
    bt = host_dtype(spec.buffer_dtype)
    if shard is not None:
        sh = spec.shard
        if sh is None:
            raise ValueError("pack_row(shard=...) needs a sharded spec")
        row = np.zeros((sh.row_len,), bt)
        off = 0
        for piece in sh.pieces[shard]:
            i, ax, a, b = piece
            leaf = to_host(leaf_rows[i])
            part = leaf if ax < 0 else \
                leaf[(slice(None),) * ax + (slice(a, b),)]
            flat = cast(np.ascontiguousarray(part).reshape(-1), bt)
            row[off:off + flat.size] = flat
            off += flat.size
        return codec.encode(row) if codec is not None else row
    row = np.concatenate([
        cast(to_host(x).reshape(-1), bt) for x in leaf_rows
    ]) if len(leaf_rows) else np.zeros((0,), bt)
    return codec.encode(row) if codec is not None else row


def assemble_rows(shard_rows: Sequence[np.ndarray], spec: PackSpec,
                  codec=None) -> List[np.ndarray]:
    """ONE rank's full per-leaf arrays from all S shard rows (each the
    padded ``[row_len]`` row :func:`pack_row` produced): the host inverse
    of the rotation, with no collective."""
    sh = spec.shard
    if sh is None:
        raise ValueError("assemble_rows needs a sharded spec")
    if len(shard_rows) != sh.factor:
        raise ValueError(
            f"assemble_rows: got {len(shard_rows)} shard rows for a "
            f"factor-{sh.factor} spec")
    out = [np.zeros(shape, host_dtype(dt))
           for shape, dt in zip(spec.shapes, spec.dtypes)]
    bt = host_dtype(spec.buffer_dtype)
    for s in range(sh.factor):
        row = shard_rows[s]
        if codec is not None:
            row = codec.decode(np.asarray(row).reshape(-1).view(np.uint8),
                               bt, sh.row_len)
        row = to_host(row).reshape(-1)
        off = 0
        for piece in sh.pieces[s]:
            i, ax, a, b = piece
            shape = _piece_shape(spec.shapes[i], piece)
            size = int(np.prod(shape)) if shape else 1
            part = cast(row[off:off + size].reshape(shape),
                        host_dtype(spec.dtypes[i]))
            if ax < 0:
                out[i][...] = part
            else:
                out[i][(slice(None),) * ax + (slice(a, b),)] = part
            off += size
    return out
