"""Wire codecs of the hosted window plane: shrink the deposit payload.

Counterpart of ``bluefog_tpu/ops/codec.py``, in numpy on the host (the
hosted plane folds on the host, as in the JAX package). A codec sits
between the deposit's wire-dtype row and the owner's fold; scalars
(push-sum p, versions, mutexes) never compress.

* ``int8`` — per-block symmetric quantization: each block of
  ``BFT_WIN_CODEC_BLOCK`` elements carries one f32 scale (``amax / 127``)
  and int8 codes.
* ``fp8`` — per-block scale onto the float8_e4m3 grid (``amax / 448``) and
  1-byte codes.
* ``topk:<frac>`` — the largest ``frac`` of the row by magnitude as
  (index, value) records, with error feedback kept by the window.

Every payload is self-describing (block size / k ride it) and its bytes are
the JAX package's for the same row: ``tests/test_torch_port_codec.py``
holds them equal.

Host rows of bfloat16 windows are numpy ``uint16`` arrays of the bf16 bit
patterns (:data:`BF16`): the port keeps no ``ml_dtypes``. A wire dtype is
never an integer type (integer windows ship f32), so ``uint16`` there
always means bf16. fp8 codes go through ``torch.float8_e4m3fn``, whose
cast rounds to nearest even as ``ml_dtypes`` does; the two part only above
464 (torch saturates, ``ml_dtypes`` makes NaN), which the block scale keeps
every finite block below (``|x| / (amax / 448) <= 448 (1 + 2^-23)``); a
block holding inf or NaN gets ``ml_dtypes``' NaN codes explicitly.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..runtime.config import knob_env
from ..runtime.logging import logger

# codec ids ride the deposit header's mode byte (high nibble): 0 means no
# codec, and the raw wire's mode byte (0 put / 1 accumulate) stays as it was
CODEC_NONE = 0
CODEC_INT8 = 1
CODEC_FP8 = 2
CODEC_TOPK = 3

_F8_MAX = 448.0  # float8_e4m3 largest finite magnitude
_DEFAULT_TOPK_FRAC = 0.01

# host representation of bfloat16 rows: the bit patterns as uint16
BF16 = np.dtype(np.uint16)


def _block_size() -> int:
    b = int(knob_env("BFT_WIN_CODEC_BLOCK") or 4096)
    return max(64, b)


def to_f32(arr: np.ndarray) -> np.ndarray:
    """A host row as float32 (bf16 bit patterns widen exactly)."""
    arr = np.asarray(arr)
    if arr.dtype == BF16:
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.astype(np.float32, copy=False)


def cast(arr: np.ndarray, dtype) -> np.ndarray:
    """``arr.astype(dtype)`` where ``BF16`` stands for bfloat16: to bf16
    rounds to nearest even (torch's cast, the same as ``ml_dtypes``'),
    from bf16 widens exactly."""
    dtype = np.dtype(dtype)
    arr = np.asarray(arr)
    if arr.dtype == dtype:
        return arr
    if dtype == BF16:
        t = torch.from_numpy(np.ascontiguousarray(
            arr.astype(np.float32, copy=False)))
        return t.to(torch.bfloat16).view(torch.int16).numpy().view(BF16)
    if arr.dtype == BF16:
        return to_f32(arr).astype(dtype, copy=False)
    return arr.astype(dtype)


def _f8_encode(x: np.ndarray) -> np.ndarray:
    """float32 -> float8_e4m3fn bit patterns (uint8)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.float8_e4m3fn).view(torch.uint8).numpy()


def _f8_decode(codes: np.ndarray) -> np.ndarray:
    """float8_e4m3fn bit patterns (uint8) -> float32."""
    t = torch.from_numpy(np.ascontiguousarray(codes))
    return t.view(torch.float8_e4m3fn).to(torch.float32).numpy()


def _as_f32_flat(arr) -> np.ndarray:
    return to_f32(np.ascontiguousarray(arr).reshape(-1))


def _blocked(flat: np.ndarray, block: int):
    """(padded [nb, block] view, nb). Padding is zeros (quantizes to 0)."""
    n = flat.size
    nb = max(1, -(-n // block))
    pad = nb * block - n
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    return flat.reshape(nb, block), nb


def _scales(blocks: np.ndarray, full: float) -> np.ndarray:
    """Per-block f32 scale mapping each block's amax onto ``full``
    (``max(max, -min)``: two reductions that write nothing, where
    ``np.abs`` would materialize a row-sized temporary)."""
    amax = np.maximum(blocks.max(axis=1), -blocks.min(axis=1))
    return (amax / full).astype(np.float32)


def _scale_inplace(x: np.ndarray, scale: np.ndarray, block: int,
                   count: int) -> None:
    """``x[i] *= scale[i // block]`` without a repeated scale vector."""
    nf = count // block
    if nf:
        x[:nf * block].reshape(nf, block)[...] *= scale[:nf, None]
    if count > nf * block:
        x[nf * block:] *= scale[nf]


def _raw_u8(raw) -> np.ndarray:
    if isinstance(raw, (bytes, bytearray, memoryview)):
        return np.frombuffer(raw, np.uint8)
    return raw.reshape(-1)


def _pack(block: int, scale: np.ndarray, codes: np.ndarray,
          n: int) -> np.ndarray:
    """``u32 block | f32 scale[nb] | u8 code[n]``: exactly n code bytes
    (the tail block's padding never ships)."""
    nb = scale.size
    out = np.empty(4 + 4 * nb + n, np.uint8)
    out[:4] = np.frombuffer(struct.pack("<I", block), np.uint8)
    out[4:4 + 4 * nb] = scale.view(np.uint8)
    out[4 + 4 * nb:] = codes.reshape(-1)[:n]
    return out


class WireCodec:
    """One codec: flat wire-dtype row -> self-describing uint8 payload."""

    cid = CODEC_NONE
    name = "none"
    error_feedback = False
    # whether ABSOLUTE state (the published exposed-window rows) may ride
    # this codec: the quantizers yes, top-k no (a sparse snapshot would
    # zero the unsent coordinates for every reader)
    state_codec = False
    # static wire-bytes / raw-bytes estimate (f32 rows), the planner's
    # size floor before measured bytes arrive
    nominal_ratio = 1.0

    def encode(self, arr: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def decode(self, raw, dtype, count: int, scale_mul=None, out=None):
        """Decode ``raw`` back to ``count`` elements of ``dtype``.

        ``scale_mul`` folds a scalar (the deposit's edge weight) into the
        payload's own scales; ``out`` decodes straight into a caller's
        flat f32 buffer (a put's mailbox slot) and returns it."""
        raise NotImplementedError


class Int8Codec(WireCodec):
    """Per-block symmetric int8: ``q = round(x * 127 / amax_block)``."""

    cid = CODEC_INT8
    name = "int8"
    state_codec = True
    nominal_ratio = 0.26  # 1/4 + per-block scale overhead

    def encode(self, arr) -> np.ndarray:
        flat = _as_f32_flat(arr)
        n = flat.size
        block = _block_size()
        b, nb = _blocked(flat, block)
        scale = _scales(b, 127.0)
        safe = np.where(scale > 0, scale, np.float32(1.0))
        # |b| <= amax, so |t| <= 127 + ulp and rint lands on [-127, 127]
        t = b * (np.float32(1.0) / safe)[:, None]
        np.rint(t, out=t)
        return _pack(block, scale, t.astype(np.int8).view(np.uint8), n)

    def decode(self, raw, dtype, count: int, scale_mul=None, out=None):
        raw = _raw_u8(raw)
        block, = struct.unpack("<I", raw[:4].tobytes())
        nb = max(1, -(-count // block))
        scale = raw[4:4 + 4 * nb].view(np.float32)
        if scale_mul is not None and scale_mul != 1.0:
            scale = scale * np.float32(scale_mul)  # nb floats, not count
        q = raw[4 + 4 * nb:4 + 4 * nb + count].view(np.int8)
        if out is not None:
            if count == nb * block:
                np.multiply(q.reshape(nb, block), scale[:, None],
                            out=out.reshape(nb, block), casting="unsafe")
            else:
                np.copyto(out, q, casting="unsafe")
                _scale_inplace(out, scale, block, count)
            return out
        x = q.astype(np.float32)
        _scale_inplace(x, scale, block, count)
        return cast(x, dtype)


class Fp8Codec(WireCodec):
    """Per-block scaled float8_e4m3: relative precision across the block."""

    cid = CODEC_FP8
    name = "fp8"
    state_codec = True
    nominal_ratio = 0.26

    def encode(self, arr) -> np.ndarray:
        flat = _as_f32_flat(arr)
        n = flat.size
        block = _block_size()
        b, nb = _blocked(flat, block)
        scale = _scales(b, _F8_MAX)
        safe = np.where(scale > 0, scale, np.float32(1.0))
        q = b / safe[:, None]
        codes = _f8_encode(q)
        bad = ~np.isfinite(scale)
        if bad.any():
            # a block holding inf or NaN keeps scale 1, so its codes may
            # pass 464: NaN there, as ml_dtypes' cast gives (torch's
            # saturates to +-448)
            qb = q[bad]
            codes[bad] = np.where(np.abs(qb) > 464.0,
                                  np.where(np.signbit(qb), 0xFF, 0x7F),
                                  codes[bad]).astype(np.uint8)
        return _pack(block, scale, codes, n)

    def decode(self, raw, dtype, count: int, scale_mul=None, out=None):
        raw = _raw_u8(raw)
        block, = struct.unpack("<I", raw[:4].tobytes())
        nb = max(1, -(-count // block))
        scale = raw[4:4 + 4 * nb].view(np.float32)
        if scale_mul is not None and scale_mul != 1.0:
            scale = scale * np.float32(scale_mul)
        x = _f8_decode(raw[4 + 4 * nb:4 + 4 * nb + count])
        if out is not None:
            np.copyto(out, x, casting="unsafe")
            _scale_inplace(out, scale, block, count)
            return out
        _scale_inplace(x, scale, block, count)
        return cast(x, dtype)


class TopKCodec(WireCodec):
    """Top-k by magnitude: ``u32 k | u32 idx[k] | f32 val[k]`` records.

    ``error_feedback=True``: the window keeps a residual per owned source
    row so the dropped coordinates are sent on later steps, never lost.
    """

    cid = CODEC_TOPK
    error_feedback = True

    def __init__(self, frac: float) -> None:
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk fraction must be in (0, 1], got {frac}")
        self.frac = float(frac)
        self.name = f"topk:{frac:g}"
        # u32 index + f32 value per kept element vs 4 raw bytes/element
        self.nominal_ratio = min(1.0, 2.0 * self.frac)

    def encode(self, arr) -> np.ndarray:
        flat = _as_f32_flat(arr)
        n = flat.size
        k = max(1, min(n, int(round(self.frac * n))))
        if k >= n:
            idx = np.arange(n, dtype=np.uint32)
        else:
            part = np.argpartition(np.abs(flat), n - k)[n - k:]
            idx = np.sort(part).astype(np.uint32)
        vals = flat[idx].astype(np.float32)
        out = np.empty(4 + 8 * k, np.uint8)
        out[:4] = np.frombuffer(struct.pack("<I", k), np.uint8)
        out[4:4 + 4 * k] = idx.view(np.uint8)
        out[4 + 4 * k:] = vals.view(np.uint8)
        return out

    def decode(self, raw, dtype, count: int, scale_mul=None, out=None):
        raw = _raw_u8(raw)
        k, = struct.unpack("<I", raw[:4].tobytes())
        idx = raw[4:4 + 4 * k].view(np.uint32)
        vals = raw[4 + 4 * k:4 + 8 * k].view(np.float32)
        if k and int(idx.max()) >= count:
            raise ValueError(
                f"top-k deposit names index {int(idx.max())} beyond the "
                f"{count}-element row — mismatched window shape across "
                "controllers")
        if scale_mul is not None and scale_mul != 1.0:
            vals = vals * np.float32(scale_mul)  # k floats, not count
        if out is not None:
            out[:] = 0.0
            out[idx] = vals
            return out
        dense = np.zeros(count, np.float32)
        dense[idx] = vals
        return cast(dense, dtype)


_warned_bad_spec = set()


def resolve(spec) -> Optional[WireCodec]:
    """``BFT_WIN_CODEC`` value -> codec instance (None = the raw wire).

    Grammar: ``none | int8 | fp8 | topk:<frac> | topk``. An unknown spec
    warns once and falls back to ``none``.
    """
    if not spec:
        return None
    s = str(spec).strip().lower()
    if s in ("", "none", "0"):
        return None
    if s == "int8":
        return Int8Codec()
    if s == "fp8":
        return Fp8Codec()
    if s == "topk":
        return TopKCodec(_DEFAULT_TOPK_FRAC)
    if s.startswith("topk:"):
        try:
            return TopKCodec(float(s.split(":", 1)[1]))
        except ValueError:
            pass
    if s not in _warned_bad_spec:
        _warned_bad_spec.add(s)
        logger.warning(
            "BFT_WIN_CODEC=%r is not none|int8|fp8|topk:<frac>; running "
            "the uncompressed wire", spec)
    return None


def resolve_edge_spec(spec) -> Tuple[Optional[WireCodec],
                                     Dict[Tuple[int, int],
                                          Optional[WireCodec]]]:
    """Per-edge grammar ``<spec>(;<src>><dst>=<spec>)*`` -> (base codec,
    {(src, dst): codec}). A malformed edge term warns once and is skipped;
    a bare single-codec spec returns ``(codec, {})``."""
    if not spec:
        return None, {}
    parts = str(spec).split(";")
    base = resolve(parts[0])
    overrides: Dict[Tuple[int, int], Optional[WireCodec]] = {}
    for term in parts[1:]:
        term = term.strip()
        if not term:
            continue
        head, sep, sub = term.partition("=")
        ok = bool(sep)
        if ok:
            try:
                src_s, dst_s = head.split(">", 1)
                edge = (int(src_s), int(dst_s))
            except ValueError:
                ok = False
        if not ok:
            key = f"edge:{term}"
            if key not in _warned_bad_spec:
                _warned_bad_spec.add(key)
                logger.warning(
                    "BFT_WIN_CODEC: skipping malformed per-edge term %r "
                    "(grammar: <spec>;<src>><dst>=<spec>;...)", term)
            continue
        overrides[edge] = resolve(sub)
    return base, overrides


def state_codec_for(codec: Optional[WireCodec]) -> Optional[WireCodec]:
    """The codec a window publishes its ABSOLUTE state rows under: the
    quantizers themselves, int8 for top-k, None (raw rows) without a
    codec."""
    if codec is None:
        return None
    if codec.state_codec:
        return codec
    return Int8Codec()


def by_id(cid: int) -> WireCodec:
    """Decode-side lookup from the deposit header's codec id (never this
    process's environment; top-k's k rides the payload)."""
    if cid == CODEC_INT8:
        return Int8Codec()
    if cid == CODEC_FP8:
        return Fp8Codec()
    if cid == CODEC_TOPK:
        return TopKCodec(_DEFAULT_TOPK_FRAC)
    raise ValueError(f"unknown wire codec id {cid} in deposit header — "
                     "origin runs a newer codec than this build")


def quantize_blend(x: torch.Tensor, cid: int) -> torch.Tensor:
    """The quantization codecs on the collective plane's blend: one
    per-tensor symmetric scale onto the int8 / fp8 grid the hosted wire
    ships, on the tensor's device. Identity for ``none`` and top-k."""
    if cid not in (CODEC_INT8, CODEC_FP8):
        return x
    xf = x.to(torch.float32)
    a = xf.abs().max()
    one = torch.ones((), dtype=torch.float32, device=x.device)
    if cid == CODEC_INT8:
        s = torch.where(a > 0, a / 127.0, one)
        q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
        return (q.to(torch.float32) * s).to(x.dtype)
    s = torch.where(a > 0, a / _F8_MAX, one)
    q = (xf / s).to(torch.float8_e4m3fn)
    return (q.to(torch.float32) * s).to(x.dtype)


__all__: List[str] = [
    "CODEC_NONE", "CODEC_INT8", "CODEC_FP8", "CODEC_TOPK", "BF16",
    "WireCodec", "Int8Codec", "Fp8Codec", "TopKCodec",
    "resolve", "resolve_edge_spec", "by_id", "state_codec_for",
    "quantize_blend", "to_f32", "cast",
]
