"""Serving plane: versioned snapshot distribution and read-only inference.

Counterpart of ``bluefog_tpu/serving``: training publishes versioned,
immutable model snapshots over the KV wire (``bf.serve.snap.<ver>.<shard>``
behind the monotone ``bf.serve.ver`` fence, written only after every shard
landed), and any process with a raw control-plane client pulls them; a
:class:`ServeClient` hot-swaps them onto its device and serves batched
inference behind an admission gate. Nothing here needs a process group.
"""

from .snapshot import (  # noqa: F401
    GC_FLOOR_KEY,
    META_KEY,
    PUB_STEP_KEY,
    PUB_TS_KEY,
    SNAP_KEY_FMT,
    VER_KEY,
    SnapshotGone,
    SnapshotMeta,
    SnapshotPublisher,
    current_version,
    fetch_meta,
    fetch_snapshot,
    read_serve_status,
    serve_shard_count,
)
from .client import RequestShed, ServeClient, serve_client  # noqa: F401

__all__ = [
    "SNAP_KEY_FMT", "VER_KEY", "META_KEY", "PUB_TS_KEY", "PUB_STEP_KEY",
    "GC_FLOOR_KEY", "SnapshotMeta", "SnapshotPublisher", "SnapshotGone",
    "current_version", "fetch_meta", "fetch_snapshot", "read_serve_status",
    "serve_shard_count", "ServeClient", "RequestShed", "serve_client",
]
