"""Versioned, immutable model snapshots over the control-plane KV wire.

Counterpart of ``bluefog_tpu/serving/snapshot.py``; the wire is the JAX
package's byte for byte, so a reader of either package fetches a snapshot
the other published. A snapshot is the model's parameters raveled to ONE
float32 vector, cut into ``S`` contiguous segments ("snapshot shards",
independent pull units), each published under::

    bf.serve.snap.<ver>.<shard>

as a 24-byte header + payload::

    <IBBHQQ  magic, codec_id, flags, shard, ver, element_count

followed by raw little-endian float32 bytes (codec 0) or an
``ops/codec.py`` payload (int8/fp8; top-k is never used for state and
:func:`~bluefog_tpu_torch.ops.codec.state_codec_for` substitutes int8).

**Version fence.** A version's keys never change once written (they are
only GC'd). The monotone ``bf.serve.ver`` (``put_max``) moves only after
every shard of that version landed, so a reader that reads the fence and
then its keys never sees a torn snapshot: a publisher killed mid-publish
leaves the fence at the last complete version. Versions beyond the keep
window (``BFT_SERVE_KEEP``) are overwritten with empty bytes;
``bf.serve.gc_floor`` (monotone) names the oldest kept, so a reader tells
"GC'd" from "never existed".

The publisher takes numpy arrays or tensors (any device: tensors are
raveled on their device and copied to the host once); a bf16 parameter is
published as float32 and its meta keeps the name ``bfloat16``.
"""

from __future__ import annotations

import json
import struct
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import codec as _codec
from ..runtime import flight as _flight
from ..runtime.config import knob_env
from ..runtime.logging import logger

SNAP_KEY_FMT = "bf.serve.snap.{ver}.{shard}"
VER_KEY = "bf.serve.ver"
META_KEY = "bf.serve.meta"
PUB_TS_KEY = "bf.serve.pub_ts"
PUB_STEP_KEY = "bf.serve.pub_step"
GC_FLOOR_KEY = "bf.serve.gc_floor"
CLIENTS_KEY = "bf.serve.clients"
CLIENT_HB_FMT = "bf.serve.client.{cid}"
LINEAGE_KEY_FMT = "bf.serve.lineage.{ver}"

_MAGIC = 0x56734642  # "BFsV" little-endian
_HDR = struct.Struct("<IBBHQQ")

# header flags bit: a lineage record rides this version's KV sidecar
# (decode ignores flags, so pre-tracing readers interoperate unchanged)
FLAG_LINEAGE = 0x1


class SnapshotGone(RuntimeError):
    """A shard of the requested version is no longer (or not yet) on the
    wire — the version was GC'd beneath the reader, who should re-read
    the fence and retry at the current version."""


def _put_float(cl, key: str, value: float) -> None:
    cl.put(key, struct.unpack("<q", struct.pack("<d", float(value)))[0])


def _get_float(cl, key: str) -> float:
    return struct.unpack("<d", struct.pack("<q", int(cl.get(key))))[0]


class SnapshotMeta:
    """Shape/dtype/striping sidecar (``bf.serve.meta``, JSON).

    Published once (it only depends on the model structure and shard
    count, never on the version), so a fetch is ``1 + S`` reads. The
    float32 flat layout is the concatenation of every leaf raveled in
    tree-flatten order; ``boundaries[s]:boundaries[s+1]`` is shard ``s``'s
    element range.
    """

    def __init__(self, leaves: Sequence[Tuple[Tuple[int, ...], str]],
                 shards: int) -> None:
        self.leaves = [(tuple(int(d) for d in shp), str(dt))
                       for shp, dt in leaves]
        self.sizes = [int(np.prod(shp, dtype=np.int64)) if shp else 1
                      for shp, _ in self.leaves]
        self.total = int(sum(self.sizes))
        self.shards = max(1, min(int(shards), max(1, self.total)))
        self.boundaries = [self.total * s // self.shards
                           for s in range(self.shards + 1)]

    @classmethod
    def for_arrays(cls, arrays: Sequence, shards: int) -> "SnapshotMeta":
        return cls([(tuple(a.shape), _dtype_name(a.dtype))
                    for a in arrays], shards)

    def to_json(self) -> bytes:
        return json.dumps({
            "fmt": 1,
            "shards": self.shards,
            "leaves": [[list(shp), dt] for shp, dt in self.leaves],
        }, sort_keys=True).encode()

    @classmethod
    def from_json(cls, blob) -> "SnapshotMeta":
        doc = json.loads(bytes(blob).decode())
        if doc.get("fmt") != 1:
            raise ValueError(
                f"snapshot meta format {doc.get('fmt')!r} is newer than "
                "this build understands")
        return cls([(tuple(shp), dt) for shp, dt in doc["leaves"]],
                   doc["shards"])

    def segment(self, shard: int) -> Tuple[int, int]:
        return self.boundaries[shard], self.boundaries[shard + 1]

    def split(self, flat: np.ndarray) -> List[np.ndarray]:
        """Flat float32 vector -> leaves in their declared shapes/dtypes
        (a bf16 leaf comes back float32: numpy has no bf16)."""
        out: List[np.ndarray] = []
        off = 0
        for (shp, dt), n in zip(self.leaves, self.sizes):
            seg = flat[off:off + n]
            off += n
            try:
                arr = seg.astype(np.dtype(dt), copy=False)
            except TypeError:
                arr = seg  # non-numpy dtype name (bfloat16): keep f32
            out.append(arr.reshape(shp))
        return out


def serve_shard_count() -> int:
    """Snapshot pull-unit count: ``BFT_SERVE_SHARDS``, falling back
    to the window shard factor (``BFT_WIN_SHARD``) so a sharded trainer's serving plane
    stripes the same way its gossip wire does."""
    s = int(knob_env("BFT_SERVE_SHARDS") or 0)
    if s <= 0:
        s = int(knob_env("BFT_WIN_SHARD") or 1)
    return max(1, s)


def resolve_serve_codec(train_codec=None):
    """The snapshot codec: ``BFT_SERVE_CODEC`` when set (``none``
    forces raw), else the trainer's wire codec routed through
    ``state_codec_for`` (bounded-error dense state only — top-k falls
    back to int8, exactly like published window rows)."""
    spec = knob_env("BFT_SERVE_CODEC")
    if spec:
        return _codec.state_codec_for(_codec.resolve(spec))
    return _codec.state_codec_for(train_codec)


def _dtype_name(dtype) -> str:
    """numpy's name of a dtype (``float32``), torch's too (``bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


def flatten_leaves(arrays: Sequence) -> np.ndarray:
    """Leaves -> one contiguous float32 host vector (the snapshot layout).
    Tensors ravel on their device, then cross to the host in one copy."""
    if not arrays:
        return np.zeros(0, np.float32)
    if all(isinstance(a, torch.Tensor) for a in arrays):
        with torch.no_grad():
            flat = torch.cat([a.detach().reshape(-1).float()
                              for a in arrays])
        return flat.cpu().numpy()
    return np.concatenate(
        [np.asarray(a).reshape(-1).astype(np.float32, copy=False)
         for a in arrays])


def encode_shard(flat: np.ndarray, meta: SnapshotMeta, shard: int,
                 ver: int, codec=None, flags: int = 0) -> bytes:
    lo, hi = meta.segment(shard)
    seg = np.ascontiguousarray(flat[lo:hi], np.float32)
    if codec is None:
        payload = seg.view(np.uint8)
        cid = _codec.CODEC_NONE
    else:
        payload = codec.encode(seg)
        cid = codec.cid
    out = np.empty(_HDR.size + payload.nbytes, np.uint8)
    out[:_HDR.size] = np.frombuffer(
        _HDR.pack(_MAGIC, cid, flags & 0xFF, shard, ver, hi - lo), np.uint8)
    out[_HDR.size:] = payload.reshape(-1)
    return out.tobytes()


def decode_shard(blob, meta: SnapshotMeta, shard: int,
                 ver: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """One published shard payload -> (float32 segment, its version).

    Empty/GC'd slots raise :class:`SnapshotGone`; anything structurally
    wrong (bad magic, wrong shard, wrong element count) raises
    ValueError — immutable keys make that corruption, not a race.
    """
    if blob is None or len(blob) == 0:
        raise SnapshotGone(
            f"snapshot shard {shard} of version {ver} is not on the wire "
            "(GC'd past the keep window, or never published)")
    raw = np.frombuffer(blob, np.uint8) if not isinstance(
        blob, np.ndarray) else blob
    if raw.size < _HDR.size:
        raise ValueError(
            f"snapshot shard {shard}: {raw.size}-byte payload is shorter "
            "than the header")
    magic, cid, _flags, got_shard, got_ver, count = _HDR.unpack_from(
        raw[:_HDR.size].tobytes())
    if magic != _MAGIC:
        raise ValueError(
            f"snapshot shard {shard}: bad magic {magic:#x} (key collision "
            "with a non-serving bytes slot?)")
    if got_shard != shard:
        raise ValueError(
            f"snapshot shard index mismatch: key says {shard}, header "
            f"says {got_shard}")
    if ver is not None and got_ver != ver:
        raise ValueError(
            f"snapshot shard {shard}: header version {got_ver} under a "
            f"version-{ver} key — immutable-key contract violated")
    lo, hi = meta.segment(shard)
    if count != hi - lo:
        raise ValueError(
            f"snapshot shard {shard}: {count} elements on the wire, meta "
            f"says {hi - lo} — stale bf.serve.meta?")
    payload = raw[_HDR.size:]
    if cid == _codec.CODEC_NONE:
        if payload.nbytes != 4 * count:
            raise ValueError(
                f"snapshot shard {shard}: raw payload is {payload.nbytes} "
                f"bytes for {count} float32 elements")
        seg = payload.view(np.float32).copy()
    else:
        seg = _codec.by_id(cid).decode(payload, np.float32, int(count))
    return seg, int(got_ver)


def current_version(cl) -> int:
    """The committed snapshot version (0 = nothing published yet)."""
    return max(0, int(cl.get(VER_KEY)))


def trace_flow_id(key: str) -> int:
    """Stable 63-bit flow id for a snapshot shard key. The publisher's
    FLOW_S and the puller's FLOW_F derive the same id from the key alone —
    that shared id is what binds the two ring records into one chrome flow
    arrow when per-process dumps are merged."""
    h = 0xCBF29CE484222325
    for ch in key.encode():
        h = ((h ^ ch) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h & 0x7FFFFFFFFFFFFFFF


def read_lineage(cl, ver: int) -> Optional[dict]:
    """The publisher-stamped lineage record for a committed version:
    ``{"fmt", "ver", "step", "rank", "codec", "wall_us"}`` — which
    training step (on which rank, through which codec, at what wall
    clock) produced the bytes that answered a request. None when absent
    (tracing off at the publisher, pre-tracing publisher, or GC'd)."""
    try:
        blob = cl.get_bytes(LINEAGE_KEY_FMT.format(ver=int(ver)))
    except (OSError, RuntimeError):
        return None
    if not blob:
        return None
    try:
        doc = json.loads(bytes(blob).decode())
    except (ValueError, UnicodeDecodeError):
        return None
    return doc if doc.get("fmt") == 1 else None


def fetch_meta(cl) -> Optional[SnapshotMeta]:
    try:
        blob = cl.get_bytes(META_KEY)
    except (OSError, RuntimeError):
        return None
    if not blob:
        return None
    return SnapshotMeta.from_json(blob)


def snap_keys(meta: SnapshotMeta, ver: int) -> List[str]:
    return [SNAP_KEY_FMT.format(ver=ver, shard=s)
            for s in range(meta.shards)]


def fetch_snapshot(cl, meta: Optional[SnapshotMeta] = None,
                   ver: Optional[int] = None, pull=None, retries: int = 4):
    """Pull one complete snapshot.

    Returns ``(leaves, version, wire_bytes)`` or ``None`` when nothing
    is committed yet. ``pull(keys) -> [blob]`` injects a transport (the
    serve client passes its parallel per-endpoint puller; the default is
    the attached client's pipelined ``get_bytes_many``). A version GC'd
    mid-pull re-reads the fence and retries at the current version —
    with a positive keep window that terminates unless the reader lags
    the publisher by the whole window every attempt.
    """
    if meta is None:
        meta = fetch_meta(cl)
        if meta is None:
            return None
    pinned = ver is not None
    last: Optional[Exception] = None
    for _ in range(max(1, retries)):
        v = ver if pinned else current_version(cl)
        if not v:
            return None
        keys = snap_keys(meta, v)
        blobs = pull(keys) if pull is not None else cl.get_bytes_many(keys)
        try:
            segs = [decode_shard(b, meta, s, v)[0]
                    for s, b in enumerate(blobs)]
        except SnapshotGone as exc:
            if pinned:
                raise
            last = exc
            continue
        flat = segs[0] if len(segs) == 1 else np.concatenate(segs)
        wire = sum(len(b) for b in blobs if b is not None)
        return meta.split(flat), v, int(wire)
    raise SnapshotGone(
        f"snapshot fetch lost the GC race {retries} times in a row "
        f"(last: {last}); raise BFT_SERVE_KEEP on the publisher")


class SnapshotPublisher:
    """Training-side publisher: encode, land every shard, THEN move the
    fence; GC versions beyond the keep window. One publisher per job
    (the optimizer hook runs it on controller 0 only) — the fence is
    monotone ``put_max``, so even a misconfigured second publisher can
    only ever advance it to a version whose shards are fully landed."""

    def __init__(self, cl, shards: Optional[int] = None, codec=None,
                 keep: Optional[int] = None) -> None:
        self._cl = cl
        self._shards = shards if shards and shards > 0 \
            else serve_shard_count()
        self._codec = codec
        keep = int(knob_env("BFT_SERVE_KEEP")) if keep is None \
            else int(keep)
        self._keep = max(1, keep)
        self._meta: Optional[SnapshotMeta] = None
        self._committed: List[int] = []
        self._last_ver = 0
        # request-path tracing (BFT_TRACE_SERVE): when on, every
        # publish stamps a lineage record and records publish spans +
        # per-shard flow starts; when off, nothing new touches the wire
        # or the ring (the zero-touch pin).
        self._trace = bool(knob_env("BFT_TRACE_SERVE"))
        # for tests: sleep between shard writes so a test can SIGKILL
        # this process mid-publish
        self._inter_shard_sleep = 0.0

    @property
    def meta(self) -> Optional[SnapshotMeta]:
        return self._meta

    def publish(self, arrays: Sequence, ver: int,
                step: Optional[int] = None) -> Dict[str, float]:
        """Publish ``arrays`` as version ``ver`` (must be > the last
        version this publisher committed). Returns wire accounting:
        ``raw_bytes``, ``wire_bytes``, ``seconds``, ``version``."""
        ver = int(ver)
        if ver <= self._last_ver:
            raise ValueError(
                f"snapshot versions are monotone: {ver} after "
                f"{self._last_ver}")
        t0 = time.perf_counter()
        if self._meta is None:
            self._meta = SnapshotMeta.for_arrays(
                [a if isinstance(a, torch.Tensor) else np.asarray(a)
                 for a in arrays], self._shards)
            self._cl.put_bytes(META_KEY, self._meta.to_json())
        flat = flatten_leaves(arrays)
        if flat.size != self._meta.total:
            raise ValueError(
                f"snapshot publish: {flat.size} elements, meta declares "
                f"{self._meta.total} — model structure changed under a "
                "live publisher")
        keys = snap_keys(self._meta, ver)
        flags = FLAG_LINEAGE if self._trace else 0
        blobs = [encode_shard(flat, self._meta, s, ver, self._codec,
                              flags=flags)
                 for s in range(self._meta.shards)]
        rec = _flight.recorder() if self._trace else None
        if rec is not None:
            rec.begin("serve.publish", float(flat.nbytes), ver)
        if self._inter_shard_sleep > 0:
            for k, b in zip(keys, blobs):
                self._cl.put_bytes(k, b)
                if rec is not None:
                    rec.rec(_flight.FLOW_S, rec.intern("serve.snap"),
                            float(len(b)), trace_flow_id(k))
                time.sleep(self._inter_shard_sleep)
        else:
            self._cl.put_bytes_many(keys, blobs)
            if rec is not None:
                for k, b in zip(keys, blobs):
                    rec.rec(_flight.FLOW_S, rec.intern("serve.snap"),
                            float(len(b)), trace_flow_id(k))
        if self._trace:
            # lineage lands BEFORE the fence so a reader that saw the
            # fence move can always resolve the producing step
            lineage = {"fmt": 1, "ver": ver,
                       "step": int(step) if step is not None else -1,
                       "rank": self._lineage_rank(),
                       "codec": (self._codec.cid if self._codec
                                 else _codec.CODEC_NONE),
                       "wall_us": time.time_ns() // 1000}
            self._cl.put_bytes(LINEAGE_KEY_FMT.format(ver=ver),
                               json.dumps(lineage, sort_keys=True).encode())
        # every shard is on the wire: move the fence, then the gauges
        self._cl.put_max(VER_KEY, ver)
        if rec is not None:
            rec.end("serve.publish", float(flat.nbytes), ver)
        self._last_ver = ver
        _put_float(self._cl, PUB_TS_KEY, time.time())
        if step is not None:
            self._cl.put(PUB_STEP_KEY, int(step))
        self._committed.append(ver)
        self._gc()
        return {"version": ver, "raw_bytes": float(flat.nbytes),
                "wire_bytes": float(sum(len(b) for b in blobs)),
                "seconds": time.perf_counter() - t0}

    def _lineage_rank(self) -> int:
        try:
            from ..runtime import metrics as _metrics

            return int(_metrics._process_index())
        except Exception:  # noqa: BLE001 — lineage is telemetry
            return 0

    def _gc(self) -> None:
        """Overwrite versions beyond the keep window with empty bytes
        (the KV has no delete op; an empty slot frees the payload and
        reads as absent). The floor moves BEFORE the bytes vanish so a
        reader can always classify a miss. Lineage sidecars are GC'd with
        their version (only when tracing stamped them — an untraced run
        never creates, nor clears, the keys)."""
        while len(self._committed) > self._keep:
            old = self._committed.pop(0)
            floor = self._committed[0]
            gc_keys = snap_keys(self._meta, old)
            if self._trace:
                gc_keys = gc_keys + [LINEAGE_KEY_FMT.format(ver=old)]
            try:
                self._cl.put_max(GC_FLOOR_KEY, floor)
                self._cl.put_bytes_many(gc_keys, [b""] * len(gc_keys))
            except (OSError, RuntimeError) as exc:
                logger.warning(
                    "serve publisher: GC of snapshot version %d failed "
                    "(%s); the slot stays until the next publish", old,
                    exc)
                return


def claim_client_slot(cl) -> int:
    """Register a serve client: reuse the first EXPIRED heartbeat slot
    (no beat for longer than ``BFT_SERVE_CLIENT_TTL_S``, or zeroed by
    a clean close) before growing ``bf.serve.clients`` — so the
    ``bf.serve.client.<cid>`` key set, the ``--status``/``--top`` client
    tables fed by it, and the admission gate's client count stay bounded
    by the PEAK concurrent client count instead of growing forever.

    Two clients registering at once can double-claim a slot; client
    identity is observability, not correctness (the same trade the
    heartbeat itself makes), and the loser's next beat simply keeps the
    shared slot warm. Returns -1 when the KV is unreachable."""
    ttl = float(knob_env("BFT_SERVE_CLIENT_TTL_S"))
    now = time.time()
    try:
        total = max(0, int(cl.get(CLIENTS_KEY)))
        for cid in range(min(total, 256)):
            ts = _get_float(cl, CLIENT_HB_FMT.format(cid=cid))
            if ts <= 0 or (ttl > 0 and now - ts > ttl):
                _put_float(cl, CLIENT_HB_FMT.format(cid=cid), now)
                return cid
        cid = int(cl.fetch_add(CLIENTS_KEY, 1))
        _put_float(cl, CLIENT_HB_FMT.format(cid=cid), now)
        return cid
    except (OSError, RuntimeError):
        return -1


def release_client_slot(cl, cid: int) -> None:
    """Zero the heartbeat on clean close so the slot reads as free
    immediately (a crashed client's slot frees via the TTL instead)."""
    if cid < 0:
        return
    try:
        _put_float(cl, CLIENT_HB_FMT.format(cid=cid), 0.0)
    except (OSError, RuntimeError):
        pass


def read_serve_status(cl, hb_window_s: Optional[float] = None
                      ) -> Optional[dict]:
    """The serving-plane status row set (a launcher's status view): committed
    version, publish lag, publisher step, GC floor, and attached-client
    counts. None when no serving plane ever published here."""
    try:
        ver = current_version(cl)
        meta_len = cl.bytes_len(META_KEY)
    except (OSError, RuntimeError):
        return None
    if ver <= 0 and meta_len <= 0:
        return None
    pub_ts = _get_float(cl, PUB_TS_KEY)
    lag = max(0.0, time.time() - pub_ts) if pub_ts > 0 else None
    if hb_window_s is None:
        hb_window_s = 6.0 * float(knob_env("BFT_SERVE_POLL_S"))
    total = max(0, int(cl.get(CLIENTS_KEY)))
    live = 0
    now = time.time()
    for cid in range(min(total, 256)):
        ts = _get_float(cl, CLIENT_HB_FMT.format(cid=cid))
        if ts > 0 and now - ts <= hb_window_s:
            live += 1
    return {
        "version": ver,
        "publish_lag_s": lag,
        "pub_step": max(0, int(cl.get(PUB_STEP_KEY))),
        "gc_floor": max(0, int(cl.get(GC_FLOOR_KEY))),
        "shards": (fetch_meta(cl).shards if meta_len > 0 else 0),
        "clients_total": total,
        "clients_live": live,
    }


def live_client_ids(cl, hb_window_s: Optional[float] = None) -> List[int]:
    """Client ids with a live heartbeat — the ``--top``/``--status``
    scan over ``bf.serve.client.<id>`` (bounded by the same 256-slot
    window as :func:`read_serve_status`)."""
    if hb_window_s is None:
        hb_window_s = 6.0 * float(knob_env("BFT_SERVE_POLL_S"))
    try:
        total = max(0, int(cl.get(CLIENTS_KEY)))
    except (OSError, RuntimeError):
        return []
    out: List[int] = []
    now = time.time()
    for cid in range(min(total, 256)):
        try:
            ts = _get_float(cl, CLIENT_HB_FMT.format(cid=cid))
        except (OSError, RuntimeError):
            continue
        if ts > 0 and now - ts <= hb_window_s:
            out.append(cid)
    return out
