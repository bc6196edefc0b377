"""Partition rules: regex rules -> per-parameter shard cuts of a window row.

Counterpart of ``bluefog_tpu/ops/partition.py``. A sharded window
(``BFT_WIN_SHARD=S``) packs one shard of the parameters into its row
instead of all of them, so every wire payload, mailbox slot and published
row shrinks by ``S``. This module decides how the parameters split:

* :func:`match_partition_rules`: an ordered list of ``(regex, axis)``
  pairs, searched in each parameter's name, first match wins; ``axis`` is
  an axis index, ``"largest"`` or ``"none"``;
* :func:`build_shard_spec`: the per-parameter decisions resolved into a
  :class:`ShardSpec`, a hashable piece table ``(leaf, axis, start, stop)``
  per shard. A parameter under the size floor, or whose chosen axis is
  shorter than ``S``, stays whole on the lightest shard.

The names are the ``.``-joined names of ``named_parameters()``
(``blocks.0.attn.qkv.weight``), where the JAX package matches flax paths
joined with ``/``. From the same shapes, dtypes, names, rules and floor the
piece table is the JAX package's, entry for entry.
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime.logging import logger

# one piece of one shard's packed row: elements [start, stop) of `axis`
# of leaf `leaf` (axis=-1: the whole, uncut leaf)
Piece = Tuple[int, int, int, int]  # (leaf, axis, start, stop)


class ShardSpec(NamedTuple):
    """Resolved partition of a parameter list into ``factor`` shards.

    ``pieces[s]`` lists shard ``s``'s pieces in parameter order;
    ``totals[s]`` is its element count; ``row_len`` is ``max(totals)``, the
    padded length every shard's row is framed to, so one window of one row
    shape carries every shard in rotation.
    """

    factor: int
    pieces: Tuple[Tuple[Piece, ...], ...]
    totals: Tuple[int, ...]
    row_len: int


def leaf_names(params) -> List[str]:
    """The names the rules match: a module's ``named_parameters()`` names,
    or the names of a sequence of ``(name, tensor)`` pairs, in order."""
    if isinstance(params, torch.nn.Module):
        params = params.named_parameters()
    return [name for name, _ in params]


def parse_rules(spec: Optional[str]):
    """``BFT_WIN_SHARD_RULES`` grammar -> ordered ``(regex, axis)``.

    Comma-separated ``regex=axis`` terms; ``axis`` is an integer,
    ``largest`` or ``none``. A malformed term is skipped with a warning.
    Empty or None -> ``[(".*", "largest")]``; the auto rule always closes
    the list."""
    if not spec:
        return [(re.compile(".*"), "largest")]
    rules = []
    for term in str(spec).split(","):
        term = term.strip()
        if not term:
            continue
        if "=" not in term:
            logger.warning(
                "BFT_WIN_SHARD_RULES term %r is not regex=axis; skipping it",
                term)
            continue
        pat, _, ax = term.rpartition("=")
        ax = ax.strip().lower()
        if ax not in ("largest", "none"):
            try:
                ax = int(ax)
            except ValueError:
                logger.warning(
                    "BFT_WIN_SHARD_RULES axis %r is not an integer, "
                    "'largest', or 'none'; skipping %r", ax, term)
                continue
        try:
            rules.append((re.compile(pat.strip()), ax))
        except re.error as exc:
            logger.warning(
                "BFT_WIN_SHARD_RULES regex %r does not compile (%s); "
                "skipping it", pat, exc)
    rules.append((re.compile(".*"), "largest"))
    return rules


def match_partition_rules(rules, names: Sequence[str],
                          shapes: Sequence[Tuple[int, ...]]):
    """Per-parameter axis (None: uncut): the first rule whose regex
    ``search``es the name wins. Scalars are never partitioned."""
    out: List[Optional[int]] = []
    for name, shape in zip(names, shapes):
        if len(shape) == 0 or int(np.prod(shape)) <= 1:
            out.append(None)
            continue
        ax: Optional[int] = None
        for pat, spec in rules:
            if pat.search(name) is None:
                continue
            if spec == "none":
                ax = None
            elif spec == "largest":
                ax = int(np.argmax(shape))
            else:
                ax = int(spec) if -len(shape) <= int(spec) < len(shape) \
                    else None
                if ax is not None and ax < 0:
                    ax += len(shape)
            break
        out.append(ax)
    return out


def _split_bounds(dim: int, factor: int) -> List[Tuple[int, int]]:
    """``factor`` contiguous chunks of ``dim``, the first ``dim % factor``
    one longer (``np.array_split``)."""
    q, r = divmod(dim, factor)
    bounds = []
    off = 0
    for i in range(factor):
        n = q + (1 if i < r else 0)
        bounds.append((off, off + n))
        off += n
    return bounds


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def build_shard_spec(shapes: Sequence[Tuple[int, ...]],
                     dtypes: Sequence,
                     factor: int,
                     names: Optional[Sequence[str]] = None,
                     rules_spec: Optional[str] = None,
                     floor_bytes: int = 0) -> ShardSpec:
    """Resolve the partition of a parameter list into ``factor`` shards
    (``dtypes`` torch or numpy). A parameter under ``floor_bytes``, or
    whose chosen axis is shorter than ``factor``, stays whole on the
    lightest shard."""
    factor = max(1, int(factor))
    names = list(names) if names is not None else \
        [str(i) for i in range(len(shapes))]
    rules = parse_rules(rules_spec)
    axes = match_partition_rules(rules, names, shapes)
    pieces: List[List[Piece]] = [[] for _ in range(factor)]
    totals = np.zeros(factor, np.int64)
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        size = int(np.prod(shape)) if shape else 1
        ax = axes[i]
        nbytes = size * _itemsize(dtype)
        if factor == 1 or ax is None or nbytes < floor_bytes or \
                shape[ax] < factor:
            s = int(np.argmin(totals))
            pieces[s].append((i, -1, 0, size))
            totals[s] += size
            continue
        per = size // shape[ax]
        for s, (a, b) in enumerate(_split_bounds(shape[ax], factor)):
            pieces[s].append((i, ax, a, b))
            totals[s] += (b - a) * per
    return ShardSpec(
        factor,
        tuple(tuple(p) for p in pieces),
        tuple(int(t) for t in totals),
        int(totals.max()) if len(totals) else 0,
    )


def spec_for_tree(named, factor: int, rules_spec: Optional[str] = None,
                  floor_bytes: int = 0) -> ShardSpec:
    """:func:`build_shard_spec` over a module's parameters or a sequence of
    ``(name, tensor)`` pairs."""
    if isinstance(named, torch.nn.Module):
        named = list(named.named_parameters())
    named = list(named)
    return build_shard_spec([tuple(t.shape) for _, t in named],
                            [t.dtype for _, t in named], factor,
                            names=leaf_names(named), rules_spec=rules_spec,
                            floor_bytes=floor_bytes)


def piece_shape(shape: Tuple[int, ...], piece: Piece) -> Tuple[int, ...]:
    """The sub-array shape one piece selects out of a leaf of ``shape``."""
    _, ax, a, b = piece
    if ax < 0:
        return shape
    return shape[:ax] + (b - a,) + shape[ax + 1:]


def piece_size(shape: Tuple[int, ...], piece: Piece) -> int:
    sh = piece_shape(shape, piece)
    return int(np.prod(sh)) if sh else 1


__all__ = [
    "ShardSpec", "Piece", "leaf_names", "parse_rules",
    "match_partition_rules", "build_shard_spec", "spec_for_tree",
    "piece_shape", "piece_size",
]
