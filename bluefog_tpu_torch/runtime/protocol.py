"""The control plane's wire op table.

Counterpart of ``bluefog_tpu/runtime/protocol.py``, row for row (a test
holds the two equal): the op codes of ``csrc/bf_runtime.cc``'s ``enum Op``
and their retry class. ``idempotent=False`` ops are applied exactly once:
the native client prefixes them with a ``kSeqPre`` annotation and the
server replays their recorded reply after a lost one. Stdlib only: the
standalone shard server imports it without torch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Tuple


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One wire op: Python name, wire code, C++ enumerator, retry class.

    ``idempotent=True`` ops are retried raw after a wire failure (applying
    them twice is harmless). ``idempotent=False`` ops must be applied
    exactly once: the client prefixes them with a ``kSeqPre`` annotation
    and the server records/replays their replies.
    """

    name: str
    code: int
    cxx: str
    idempotent: bool
    doc: str = ""


OPS: Tuple[OpSpec, ...] = (
    OpSpec("barrier", 1, "kBarrier", False,
           "blocking rendezvous; a drop-and-retry must not double-count "
           "this client's arrival"),
    OpSpec("lock", 2, "kLock", True,
           "blocking acquire; a redundant re-grant is absorbed by per-rank "
           "re-entrancy and a dropped holder is force-released server-side"),
    OpSpec("unlock", 3, "kUnlock", False,
           "double-applied it would release the NEXT holder's acquisition"),
    OpSpec("fetch_add", 4, "kFetchAdd", False,
           "atomic read-modify-write; double-applied it drifts the counter"),
    OpSpec("put", 5, "kPut", True, "last-writer-wins scalar write"),
    OpSpec("get", 6, "kGet", True, "pure read"),
    OpSpec("shutdown", 7, "kShutdown", True,
           "server stop request; repeating it is a no-op"),
    OpSpec("append_bytes", 8, "kAppendBytes", False,
           "double-applied it duplicates a mailbox deposit record"),
    OpSpec("take_bytes", 9, "kTakeBytes", False,
           "destructive drain; a retry must replay the recorded haul, not "
           "drain again"),
    OpSpec("put_bytes", 10, "kPutBytes", True,
           "last-writer-wins bulk slot overwrite"),
    OpSpec("get_bytes", 11, "kGetBytes", True, "pure bulk read"),
    OpSpec("box_bytes", 12, "kBoxBytes", True,
           "pure read of a mailbox's pending byte count"),
    OpSpec("append_bytes_tagged", 13, "kAppendBytesTagged", False,
           "tagged deposit append; same exactly-once contract as "
           "append_bytes"),
    OpSpec("put_bytes_part", 14, "kPutBytesPart", False,
           "striped-put byte range into a staging buffer; a duplicate part "
           "re-arms assembly bookkeeping"),
    OpSpec("bytes_len", 15, "kBytesLen", True, "pure read of a slot's size"),
    OpSpec("get_bytes_part", 16, "kGetBytesPart", True,
           "pure ranged bulk read"),
    OpSpec("seq_pre", 17, "kSeqPre", True,
           "the reply-less dedup annotation itself; re-sending it re-arms "
           "the same (client, seq) batch"),
    OpSpec("attach", 18, "kAttach", True,
           "incarnation registration; re-registering the same incarnation "
           "is a no-op (every reconnect re-sends it)"),
    OpSpec("put_max", 19, "kPutMax", True,
           "monotone merge (kv[key] = max(kv[key], arg)) — the shard "
           "router's replication write for membership-critical keys; "
           "commutative and idempotent by construction, so replaying it "
           "after a lost reply (or onto a failover replica) cannot regress "
           "the value"),
    OpSpec("stats", 20, "kStats", True,
           "pure read of the server's telemetry counter block — how an "
           "external actor merges per-shard views without owning the "
           "server handle"),
    OpSpec("repl_apply", 21, "kReplApply", False,
           "one WAL record streamed shard-to-shard by the replicator "
           "thread (durable control plane); the record key rides the "
           "body length-prefixed (a '\\n' in a user-derived key must not "
           "corrupt the batch key framing); double-applied it would "
           "duplicate a replicated deposit or double-advance a replicated "
           "counter, so the inter-shard stream rides kSeqPre dedup like "
           "any other non-idempotent op"),
    OpSpec("snapshot", 22, "kSnapshot", True,
           "point-in-time state dump (shard rejoin catch-up); re-reading "
           "it merely re-serializes the store, and the receiver-flagged "
           "variant's stream re-arm is idempotent too (already-live "
           "streams are untouched)"),
)

# name -> wire code (the table every Python-side consumer keys off)
OP_CODES: Dict[str, int] = {o.name: o.code for o in OPS}

# code -> name (telemetry counter rows, diagnostics)
OP_NAMES: Dict[int, str] = {o.code: o.name for o in OPS}

# Ops whose effect must be applied exactly once: the client's kSeqPre
# retry set (mirrors Client::IsDedupOp in csrc/bf_runtime.cc).
RETRY_UNSAFE: FrozenSet[str] = frozenset(
    o.name for o in OPS if not o.idempotent)


def spec(name: str) -> OpSpec:
    """The OpSpec for ``name`` (KeyError on an unknown op)."""
    for o in OPS:
        if o.name == name:
            return o
    raise KeyError(f"unknown control-plane op {name!r}")
