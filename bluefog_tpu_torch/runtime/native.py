"""ctypes binding of the native control plane (``csrc/bf_runtime.cc``).

Counterpart of ``bluefog_tpu/runtime/native.py``. The library is the
repository's ``csrc/bf_runtime.cc``, unedited: the timeline writer and the
control plane (distributed mutexes, fetch-and-op counters, barriers, a
scalar and bytes KV and deposit mailboxes, served over TCP with an HMAC
handshake, reconnects with exactly-once replay, incarnation fencing, and
WAL replication between shard servers).

The library is built at first use with ``g++`` and ``csrc/build.sh``'s
flags into ``bluefog_tpu_torch/_build/``, named by a hash of the source and
the flags (tmp file, then an atomic rename: concurrent processes may build
at once); ``BFT_NATIVE_SO`` names a prebuilt library instead. Where the
JAX package degrades to local state without a library, the port raises: a
control plane that was asked for and cannot build or load its library is
an error. Nothing is built at import.

The library reads six knobs itself (``scope="native"`` in
``runtime/config.py``) under their JAX names. The port's ``BFT_*`` values
reach it under those names for the duration of each call that reads them
(:func:`_native_knobs`), and a stray ``BLUEFOG_*`` value without its
``BFT_*`` twin is hidden from it. Shard servers export them for as long as
they serve (:func:`export_native_knobs`): the standalone shard server for
its whole life, the in-process shards of ``BFT_CP_SHARDS > 1`` until
detach, since their replication threads read them later, outside any
call.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import socket
import struct
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from .config import KNOBS, knob_env
from .logging import logger
from .protocol import OP_CODES, OP_NAMES as _OP_NAMES

_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "bf_runtime.cc"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # of this process's build, if any


class PeerLostError(RuntimeError):
    """A blocking control-plane primitive was woken because a peer died.

    Raised instead of hanging when a lock holder's connection closed (or
    its lease expired), a barrier's bounded wait hit its deadline, or a
    critical section was force-broken mid-hold; and by ``synchronize``
    when its deadline passes with a controller dead. ``dead`` carries the
    heartbeat monitor's dead-controller set at raise time (it may still be
    empty when the server noticed the death before a heartbeat timeout
    elapsed).
    """

    def __init__(self, message: str, dead=()) -> None:
        self.dead = set(dead)
        if self.dead:
            message += (f" [dead controller(s) {sorted(self.dead)} per "
                        "bf.dead_controllers()]")
        super().__init__(message)


def _dead_controller_set() -> set:
    """The heartbeat monitor's current dead set (empty when unavailable).

    Imported lazily: heartbeat -> control_plane -> native is the module
    load order, so a top-level import here would be circular."""
    try:
        from .heartbeat import dead_controllers

        return dead_controllers()
    except Exception:  # noqa: BLE001 — raise-path helper must not mask
        return set()


def _peer_lost(message: str) -> PeerLostError:
    return PeerLostError(message, dead=_dead_controller_set())


class StaleIncarnationError(RuntimeError):
    """This client's (rank, incarnation) registration was superseded.

    The same rank re-registered with a newer incarnation: this process is
    a zombie of a restarted rank. The server has garbage-collected this
    incarnation's dedup records, mailbox deposits and lock holdings, so
    the only correct reaction is to exit. Never retried by the transport.
    """


class QuorumLostError(RuntimeError):
    """A mutating control-plane op was rejected: the shard is below its
    commit quorum (quorum replication, ``BFT_CP_REPLICATION>=3``), on the
    minority side of a partition. Reads still serve; mutations raise this
    until the partition heals."""


# Status codes shared with csrc/bf_runtime.cc: -1 wire failure, -2 mailbox
# byte cap, -3 dead holder / deadline on a blocking primitive, -4 stale
# incarnation (fenced zombie), -5 below commit quorum.
_DEAD_HOLDER = -3
_STALE = -4
_QUORUM_LOST = -5


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.bf_timeline_open.restype = ctypes.c_void_p
    lib.bf_timeline_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.bf_timeline_event.restype = None
    lib.bf_timeline_event.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char,
        ctypes.c_int64, ctypes.c_int,
    ]
    lib.bf_timeline_close.restype = None
    lib.bf_timeline_close.argtypes = [ctypes.c_void_p]
    # arg-carrying events: counter tracks ('C') and flow binding
    # ('s'/'f') need an int64 value/id alongside the classic fields
    lib.bf_timeline_event2.restype = None
    lib.bf_timeline_event2.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
    ]

    lib.bf_cp_serve.restype = ctypes.c_void_p
    lib.bf_cp_serve.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.bf_cp_serve_auth.restype = ctypes.c_void_p
    lib.bf_cp_serve_auth.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_int64]
    lib.bf_cp_serve_auth2.restype = ctypes.c_void_p
    lib.bf_cp_serve_auth2.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int]
    lib.bf_cp_serve_auth3.restype = ctypes.c_void_p
    lib.bf_cp_serve_auth3.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_int]
    lib.bf_cp_server_port.restype = ctypes.c_int
    lib.bf_cp_server_port.argtypes = [ctypes.c_void_p]
    lib.bf_cp_server_stop.restype = None
    lib.bf_cp_server_stop.argtypes = [ctypes.c_void_p]
    lib.bf_cp_connect.restype = ctypes.c_void_p
    lib.bf_cp_connect.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.bf_cp_connect_auth.restype = ctypes.c_void_p
    lib.bf_cp_connect_auth.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_char_p]
    lib.bf_cp_connect_auth2.restype = ctypes.c_void_p
    lib.bf_cp_connect_auth2.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_char_p,
                                        ctypes.c_int]
    lib.bf_cp_bytes_len.restype = ctypes.c_int64
    lib.bf_cp_bytes_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bf_cp_put_bytes_part.restype = ctypes.c_int64
    lib.bf_cp_put_bytes_part.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.bf_cp_get_bytes_part.restype = ctypes.c_int64
    lib.bf_cp_get_bytes_part.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.bf_cp_put_bytes_striped.restype = ctypes.c_int64
    lib.bf_cp_put_bytes_striped.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.bf_cp_get_bytes_striped.restype = ctypes.c_int64
    lib.bf_cp_get_bytes_striped.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
    ]
    for fname in ("bf_cp_barrier", "bf_cp_lock", "bf_cp_unlock", "bf_cp_get"):
        fn = getattr(lib, fname)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    for fname in ("bf_cp_fetch_add", "bf_cp_put", "bf_cp_put_max"):
        fn = getattr(lib, fname)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    # remote per-shard counter read (sharded control plane, kStats)
    lib.bf_cp_remote_stats.restype = ctypes.c_int
    lib.bf_cp_remote_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    for fname in ("bf_cp_append_bytes", "bf_cp_put_bytes"):
        fn = getattr(lib, fname)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                       ctypes.c_int64]
    for fname in ("bf_cp_take_bytes", "bf_cp_get_bytes"):
        fn = getattr(lib, fname)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int64)]
    lib.bf_cp_free.restype = None
    lib.bf_cp_free.argtypes = [ctypes.c_void_p]
    lib.bf_cp_multi.restype = ctypes.c_int64
    lib.bf_cp_multi.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    lib.bf_cp_bytes_multi_outv.restype = ctypes.c_int64
    lib.bf_cp_bytes_multi_outv.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
    ]
    lib.bf_cp_bytes_multi_outv_tagged.restype = ctypes.c_int64
    lib.bf_cp_bytes_multi_outv_tagged.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    lib.bf_cp_bytes_multi_in.restype = ctypes.c_int64
    lib.bf_cp_bytes_multi_in.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.bf_cp_disconnect.restype = None
    lib.bf_cp_disconnect.argtypes = [ctypes.c_void_p]
    # incarnation fencing
    lib.bf_cp_attach.restype = ctypes.c_int64
    lib.bf_cp_attach.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.bf_cp_is_stale.restype = ctypes.c_int
    lib.bf_cp_is_stale.argtypes = [ctypes.c_void_p]
    lib.bf_cp_server_dedup_entries.restype = ctypes.c_longlong
    lib.bf_cp_server_dedup_entries.argtypes = [ctypes.c_void_p]
    lib.bf_cp_server_mailbox_from.restype = ctypes.c_longlong
    lib.bf_cp_server_mailbox_from.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bf_cp_server_incarnation.restype = ctypes.c_longlong
    lib.bf_cp_server_incarnation.argtypes = [ctypes.c_void_p, ctypes.c_int]
    # telemetry counter blocks
    lib.bf_cp_client_counters.restype = ctypes.c_int
    lib.bf_cp_client_counters.argtypes = [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    lib.bf_cp_server_counters.restype = ctypes.c_int
    lib.bf_cp_server_counters.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    # fault injection + dead-connection hooks
    lib.bf_cp_fault.restype = None
    lib.bf_cp_fault.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, ctypes.c_longlong]
    lib.bf_cp_fault_drops.restype = ctypes.c_longlong
    lib.bf_cp_fault_drops.argtypes = []
    lib.bf_cp_fault_ops.restype = ctypes.c_longlong
    lib.bf_cp_fault_ops.argtypes = []
    lib.bf_cp_server_drop_conns.restype = None
    lib.bf_cp_server_drop_conns.argtypes = [ctypes.c_void_p]
    # transport flight ring
    lib.bf_flight_ring.restype = ctypes.c_int
    lib.bf_flight_ring.argtypes = [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    # WAL replication + shard rejoin
    lib.bf_cp_server_set_successor.restype = ctypes.c_int
    lib.bf_cp_server_set_successor.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.bf_cp_snapshot.restype = ctypes.c_int64
    lib.bf_cp_snapshot.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64)]
    lib.bf_cp_server_load_snapshot.restype = ctypes.c_longlong
    lib.bf_cp_server_load_snapshot.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int]
    lib.bf_cp_server_set_rejoin_pending.restype = None
    lib.bf_cp_server_set_rejoin_pending.argtypes = [ctypes.c_void_p]
    lib.bf_cp_set_failover.restype = None
    lib.bf_cp_set_failover.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int]
    lib.bf_cp_failed_over.restype = ctypes.c_int
    lib.bf_cp_failed_over.argtypes = [ctypes.c_void_p]
    # quorum replication + partition injector
    lib.bf_cp_server_set_successors.restype = ctypes.c_int
    lib.bf_cp_server_set_successors.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.bf_cp_server_load_snapshot2.restype = ctypes.c_longlong
    lib.bf_cp_server_load_snapshot2.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.bf_cp_server_reset_store.restype = None
    lib.bf_cp_server_reset_store.argtypes = [ctypes.c_void_p]
    lib.bf_cp_server_rejoin_done.restype = None
    lib.bf_cp_server_rejoin_done.argtypes = [ctypes.c_void_p]
    lib.bf_cp_set_failover2.restype = None
    lib.bf_cp_set_failover2.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bf_cp_client_set_group.restype = None
    lib.bf_cp_client_set_group.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bf_cp_partition.restype = None
    lib.bf_cp_partition.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_double, ctypes.c_double]
    lib.bf_cp_partition_heal.restype = None
    lib.bf_cp_partition_heal.argtypes = []
    lib.bf_cp_partition_disarm.restype = None
    lib.bf_cp_partition_disarm.argtypes = []
    lib.bf_cp_partition_active.restype = ctypes.c_int
    lib.bf_cp_partition_active.argtypes = []
    lib.bf_cp_partition_cuts.restype = ctypes.c_longlong
    lib.bf_cp_partition_cuts.argtypes = []
    return lib


# -- deterministic fault injection (BFT_CP_FAULT) -----------------------------
#
# Spec grammar (comma-separated key=value, all integers, any subset):
#   drop_after=N   kill the client connection on every Nth control-plane op
#                  (alternating request-lost / reply-lost, the two classes
#                  the reconnect + dedup machinery must survive); 0 = off
#   delay_ms=M     sleep M ms inside every client op before the reply read
#                  (deterministic slow-peer emulation)
#   trunc=1        request-lost drops first write HALF the frame, so the
#                  server sees a truncated message, not a clean close
#   seed=S         shifts which ops the drop counter fires on
#   delay_edges=src>dst:ms,...
#                  per-EDGE deposit delay: sleep ms before the
#                  window deposit batch covering edge src->dst ships —
#                  deterministic bandwidth ASYMMETRY. Applied at the
#                  Python deposit site (:func:`edge_delays`), not inside
#                  the native client; terms after the first may ride
#                  further commas or ``;`` / ``|`` separators.
#   partition=0,1|2,3
#                  deterministic network partition: SHARD
#                  indices grouped into sides by ``|`` (bare numeric terms
#                  after the first ride the comma-separated spec). Connects
#                  and in-flight ops crossing the cut fail at the client
#                  socket layer, both directions; shards that lose their
#                  commit quorum degrade to read-only (QuorumLostError).
#                  The shard-index spec is resolved to listener ports and
#                  armed by the process that knows the port map (the
#                  shard server) via :func:`partition_arm`.
#   part_after=S   the cut activates S seconds after arming (float; 0 =
#                  immediately) — lets a soak arm it pre-fork and have it
#                  fire mid-run.
#   heal_after=S   the cut heals itself S seconds after activation
#                  (float; 0 = only on an explicit heal/disarm).
#
# OFF unless BFT_CP_FAULT is set (or a test arms it explicitly): the
# production path pays one relaxed atomic load per op, nothing else.

def _parse_edge_delays(text: str) -> dict:
    """``src>dst:ms(;src>dst:ms)*`` -> {(src, dst): ms}."""
    out: dict = {}
    for term in str(text).replace("|", ";").split(";"):
        term = term.strip()
        if not term:
            continue
        try:
            edge_s, ms_s = term.rsplit(":", 1)
            src_s, dst_s = edge_s.split(">", 1)
            out[(int(src_s), int(dst_s))] = int(ms_s)
        except ValueError:
            raise ValueError(
                f"BFT_CP_FAULT: bad delay_edges term {term!r} "
                "(grammar: delay_edges=src>dst:ms,src>dst:ms,...)")
    return out


def parse_partition_groups(text: str) -> list:
    """``"0,1|2,3"`` -> ``[[0, 1], [2, 3]]`` (shard-index sides)."""
    groups = []
    for side in str(text).split("|"):
        side = side.strip()
        if not side:
            continue
        try:
            groups.append(sorted({int(t) for t in side.split(",")
                                  if t.strip()}))
        except ValueError:
            raise ValueError(
                f"BFT_CP_FAULT: bad partition side {side!r} "
                "(grammar: partition=0,1|2,3)")
    if len(groups) < 2:
        raise ValueError(
            "BFT_CP_FAULT: partition= needs at least two '|'-separated "
            "sides (grammar: partition=0,1|2,3)")
    seen: set = set()
    for g in groups:
        if seen.intersection(g):
            raise ValueError(
                "BFT_CP_FAULT: partition sides must be disjoint")
        seen.update(g)
    return groups


def parse_fault_spec(spec: str) -> dict:
    out = {"drop_after": 0, "delay_ms": 0, "trunc": 0, "seed": 0,
           "delay_edges": {}, "partition": None, "part_after": 0.0,
           "heal_after": 0.0}
    part_raw = None
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        key, sep, val = item.partition("=")
        key = key.strip()
        if sep and key == "delay_edges":
            out["delay_edges"].update(_parse_edge_delays(val))
            continue
        if not sep and ">" in item and ":" in item:
            # continuation of a comma-separated delay_edges list
            out["delay_edges"].update(_parse_edge_delays(item))
            continue
        if sep and key == "partition":
            part_raw = val.strip()
            continue
        if not sep and part_raw is not None and \
                item.replace("|", "").replace(" ", "").isdigit():
            # continuation of the comma-separated partition group spec
            part_raw += "," + item
            continue
        if not sep or key not in out or key in ("delay_edges", "partition"):
            raise ValueError(
                f"BFT_CP_FAULT: bad entry {item!r} (grammar: "
                "drop_after=N,delay_ms=M,trunc=0|1,seed=S,"
                "delay_edges=src>dst:ms,...,partition=0,1|2,3,"
                "part_after=S,heal_after=S)")
        if key in ("part_after", "heal_after"):
            out[key] = float(val.strip())
        else:
            out[key] = int(val.strip())
    if part_raw is not None:
        out["partition"] = parse_partition_groups(part_raw)
    return out


def fault_arm(spec=None, **overrides) -> dict:
    """Arm the native fault injector from a spec string / dict / kwargs.

    Resets the op and drop counters so injected drop points are
    reproducible run to run. Returns the effective spec."""
    lib = load()
    cfg = parse_fault_spec(spec) if isinstance(spec, str) else \
        dict(spec or {"drop_after": 0, "delay_ms": 0, "trunc": 0, "seed": 0})
    cfg.update(overrides)
    lib.bf_cp_fault(int(cfg.get("drop_after", 0)),
                    int(cfg.get("delay_ms", 0)),
                    int(cfg.get("trunc", 0)), int(cfg.get("seed", 0)))
    global _edge_delays
    _edge_delays = dict(cfg.get("delay_edges") or {})
    return cfg


def fault_disarm() -> None:
    """Turn injection off (counters reset)."""
    global _edge_delays
    _edge_delays = {}
    if _lib is not None:
        _lib.bf_cp_fault(0, 0, 0, 0)


# Per-edge deposit delays live python-side (the native client has no edge
# concept — a deposit is just a keyed append): lazily parsed from the env
# so they work even where the native library is unavailable, and kept in
# sync by fault_arm / fault_disarm.
_edge_delays: Optional[dict] = None


def edge_delays() -> dict:
    """{(src, dst): ms} from BFT_CP_FAULT's delay_edges clause
    (empty unless armed). The window deposit site consults this per deposit
    batch; a malformed env spec degrades to no delays (the native arm
    path warns)."""
    global _edge_delays
    if _edge_delays is None:
        cfg: dict = {}
        spec = knob_env("BFT_CP_FAULT")
        if spec:
            try:
                cfg = parse_fault_spec(spec).get("delay_edges") or {}
            except ValueError:
                cfg = {}
        _edge_delays = cfg
    return _edge_delays


def fault_stats() -> dict:
    """{'ops': client ops seen, 'drops': connections killed} since arm."""
    lib = _lib
    if lib is None:
        return {"ops": 0, "drops": 0}
    return {"ops": int(lib.bf_cp_fault_ops()),
            "drops": int(lib.bf_cp_fault_drops())}


# -- deterministic partition injector ----------------------------------------

def partition_arm(port_groups: dict, self_group: int = -1,
                  start_after: float = 0.0, heal_after: float = 0.0) -> None:
    """Arm the native partition injector for THIS process.

    ``port_groups`` maps control-plane LISTENER ports to sides (the
    caller — shard_server, cp_soak, a test — resolves the shard-index
    spec from ``parse_fault_spec``'s ``partition`` field to ports, since
    only it knows the port map). ``self_group`` places this process's
    ordinary clients on a side (-1 = ungrouped: only server-side quorum
    gates and group-bound replicator streams enforce the cut). The cut
    activates ``start_after`` seconds from now and heals itself
    ``heal_after`` seconds after activation (0 = never / explicit only).
    """
    lib = load()
    spec = ",".join(f"{int(p)}:{int(g)}" for p, g in
                    sorted(port_groups.items()))
    lib.bf_cp_partition(int(self_group), spec.encode(),
                        float(start_after), float(heal_after))


def partition_heal() -> None:
    """Heal the armed cut now (idempotent; the cut counter survives)."""
    if _lib is not None:
        _lib.bf_cp_partition_heal()


def partition_disarm() -> None:
    """Fully disarm the injector (port map cleared)."""
    if _lib is not None:
        _lib.bf_cp_partition_disarm()


def partition_active() -> bool:
    """True while an armed cut is live (post-start, pre-heal)."""
    return bool(_lib is not None and _lib.bf_cp_partition_active())


def partition_cuts() -> int:
    """Connects/ops this process failed at the injected cut since arming
    (feeds the ``cp.partitions`` counter trail)."""
    return 0 if _lib is None else int(_lib.bf_cp_partition_cuts())


_CL_SLOTS = 100  # 3*32 per-op triples + 4 event counters (csrc layout)


def client_stats() -> dict:
    """Cumulative native-client transport counters for this process.

    ``ops`` / ``bytes_out`` / ``bytes_in`` are keyed by op class (zero
    rows suppressed); ``redials`` counts successful transparent
    reconnects, ``redial_attempts`` every dial tried, ``stale_frames``
    incarnation-fence verdicts observed on the wire, and
    ``striped_transfers`` whole striped put/get operations. Counters are
    process-global and never reset — consumers (the metrics registry)
    report deltas against their own baseline. Empty until the library is
    loaded."""
    lib = _lib
    if lib is None:
        return {}
    buf = (ctypes.c_longlong * _CL_SLOTS)()
    if lib.bf_cp_client_counters(buf, _CL_SLOTS) < 0:
        return {}
    ops, b_out, b_in = {}, {}, {}
    for code, name in _OP_NAMES.items():
        if buf[code]:
            ops[name] = int(buf[code])
        if buf[32 + code]:
            b_out[name] = int(buf[32 + code])
        if buf[64 + code]:
            b_in[name] = int(buf[64 + code])
    return {
        "ops": ops,
        "bytes_out": b_out,
        "bytes_in": b_in,
        "redials": int(buf[96]),
        "redial_attempts": int(buf[97]),
        "stale_frames": int(buf[98]),
        "striped_transfers": int(buf[99]),
    }


_FLIGHT_RING_MAX = 1024  # csrc kFlightCap


def flight_events() -> list:
    """The native transport's flight ring, oldest -> newest: a list of
    ``[wall_us, kind, a, b]`` rows (kinds: 1 redial attempt, 2 redial
    success, 3 stale frame, 4 per-stripe timing, 5 whole striped
    transfer, 6 failover redirect to the ring successor; a/b are
    bytes/micros for the timed kinds). Spliced into flight-recorder
    dumps (runtime/flight.py); empty until the library is loaded."""
    lib = _lib
    if lib is None:
        return []
    buf = (ctypes.c_longlong * (4 * _FLIGHT_RING_MAX))()
    n = lib.bf_flight_ring(buf, _FLIGHT_RING_MAX)
    return [[int(buf[4 * j]), int(buf[4 * j + 1]), int(buf[4 * j + 2]),
             int(buf[4 * j + 3])] for j in range(max(0, n))]


def _arm_fault_from_env(lib) -> None:
    spec = knob_env("BFT_CP_FAULT")
    if not spec:
        return
    try:
        cfg = parse_fault_spec(spec)
    except ValueError as exc:
        logger.warning("ignoring BFT_CP_FAULT (%s)", exc)
        return
    lib.bf_cp_fault(cfg["drop_after"], cfg["delay_ms"], cfg["trunc"],
                    cfg["seed"])
    logger.warning("control-plane fault injection ARMED: %s "
                   "(BFT_CP_FAULT — never set this in production)", cfg)


def native_knob_values() -> dict:
    """``{native name: the BFT_* value or None}`` of the six knobs the
    library reads itself (``scope="native"``)."""
    return {k.jax_name: os.environ.get(k.name) for k in KNOBS
            if k.scope == "native"}


def _set_env(name: str, value: Optional[str]) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


_env_mu = threading.Lock()


@contextlib.contextmanager
def _native_knobs():
    """The ``BFT_*`` values of the native-scope knobs under their native
    names (a name whose ``BFT_*`` twin is unset is removed) for the
    duration of the block, then the environment as it was."""
    with _env_mu:
        saved = {}
        for name, value in native_knob_values().items():
            saved[name] = os.environ.get(name)
            _set_env(name, value)
        try:
            yield
        finally:
            for name, value in saved.items():
                _set_env(name, value)


def export_native_knobs() -> dict:
    """Put the native-scope knobs under their native names until
    :func:`restore_native_knobs` (the shard servers: their replication
    threads read them outside any call). Returns the environment's own
    values of those names."""
    with _env_mu:
        saved = {}
        for name, value in native_knob_values().items():
            saved[name] = os.environ.get(name)
            _set_env(name, value)
    return saved


def restore_native_knobs(saved: dict) -> None:
    """Put back the values :func:`export_native_knobs` returned."""
    with _env_mu:
        for name, value in saved.items():
            _set_env(name, value)


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD / f"libbf_runtime_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/bf_runtime.cc`` unless this source and these flags
    were built already; returns the library's path."""
    global build_seconds
    out = _library_path()
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                              str(_SOURCE)], capture_output=True, text=True,
                             timeout=600)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"native control-plane build failed: {exc}") \
            from exc
    if res.returncode != 0:
        raise RuntimeError("native control-plane build failed:\n"
                           + res.stdout + res.stderr)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The loaded native library, building it at first use; raises
    RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = knob_env("BFT_NATIVE_SO")
        if so and not os.path.exists(so):
            raise RuntimeError(f"BFT_NATIVE_SO={so} does not exist")
        path = so or str(build())
        try:
            lib = _configure(ctypes.CDLL(path))
        except (OSError, AttributeError) as exc:
            raise RuntimeError(f"native control-plane library {path} "
                               f"failed to load: {exc}") from exc
        _arm_fault_from_env(lib)
        _lib = lib
        return lib


class NativeReply:
    """A malloc'd native reply buffer exposed as a zero-copy memoryview.

    The bulk drain path hands out record views that alias the native
    buffer directly, so a 100 MB drain is parsed without the two full
    Python-side copies ``ctypes.string_at`` + per-record slicing cost.
    Callers MUST finish consuming every view before ``close()`` (the
    views dangle afterwards); close is idempotent and runs at GC as a
    backstop.
    """

    def __init__(self, lib, ptr: "ctypes.c_void_p", length: int) -> None:
        self._lib = lib
        self._ptr = ptr
        self.view = memoryview(
            (ctypes.c_char * length).from_address(ptr.value)
        ).cast("B") if length else memoryview(b"")

    def close(self) -> None:
        if self._ptr is not None:
            self.view = memoryview(b"")
            self._lib.bf_cp_free(self._ptr)
            self._ptr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):  # backstop only; explicit close is the contract
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


# -- striped multi-connection transport knobs --------------------------------
#
# A pool of BFT_CP_STREAMS authenticated connections per (client, server)
# pair, large bodies striped across it, and tunable socket buffers at both
# ends. BFT_CP_STREAMS=1 is the strict fallback: no extra connections are
# ever opened and every byte rides the single connection.

def _env_streams() -> int:
    return max(1, min(int(knob_env("BFT_CP_STREAMS")), 16))


def _env_sockbuf_bytes() -> int:
    # 0 keeps the kernel's auto-tuned buffers: pinning SO_SNDBUF/SO_RCVBUF
    # disables Linux's buffer auto-grow; the knob is for cross-host paths
    # whose bandwidth-delay product outruns the auto-tuner's limits.
    return max(0, int(float(knob_env("BFT_CP_SOCKBUF_MB")) * (1 << 20)))


def _env_stripe_min_bytes() -> int:
    return max(1, int(float(knob_env("BFT_CP_STRIPE_MIN_MB")) * (1 << 20)))


def _blob_len(b) -> int:
    return len(b) if isinstance(b, (bytes, bytearray)) else \
        memoryview(b).nbytes


def _run_parallel(fns):
    """Run thunks on worker threads (caller runs the first); returns their
    results in order, re-raising the first failure. The native calls inside
    release the GIL, so pool connections genuinely transfer concurrently."""
    if len(fns) == 1:
        return [fns[0]()]
    results = [None] * len(fns)
    errors = []

    def run(i):
        try:
            results[i] = fns[i]()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,), daemon=True,
                                name="bf-cp-stripe")
               for i in range(1, len(fns))]
    for t in threads:
        t.start()
    run(0)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


class _MultiReply:
    """Owner over several NativeReply buffers (a pooled multi-key drain).

    Exposes no aggregate ``view`` (records alias the per-connection reply
    buffers); the attribute exists empty so callers can treat any drain
    owner uniformly, and ``close()`` invalidates every sub-buffer's views
    exactly like a single :class:`NativeReply`."""

    view = memoryview(b"")

    def __init__(self, owners) -> None:
        self._owners = list(owners)

    def close(self) -> None:
        for o in self._owners:
            o.close()
        self._owners = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_SRV_STAT_SLOTS = 53  # 32 per-op counts + 21 aggregates (csrc layout)


def _server_stats_dict(buf) -> dict:
    """Decode the 53-slot server counter block (one layout, two transports:
    the in-process bf_cp_server_counters read and the kStats wire op).
    Slots 43-47 are the WAL-replication view: ``repl_status`` is 0 when no
    successor is configured, 1 while the chain commit is live, 2 when the
    shard DEGRADED to unreplicated (an under-replicated finding). Slots
    48-52 are the quorum view: ``quorum_state`` is 0 when not in quorum
    mode (R<=2), 1 while the commit quorum holds, 2 while the shard is
    below quorum (read-only); ``replica_sources`` counts distinct incoming
    WAL streams, ``repl_targets_live`` live outgoing ones."""
    ops = {name: int(buf[code]) for code, name in _OP_NAMES.items()
           if buf[code]}
    return {
        "ops": ops,
        "live_connections": int(buf[32]),
        "mailbox_records": int(buf[33]),
        "mailbox_bytes": int(buf[34]),
        "locks_held": int(buf[35]),
        "lock_force_releases": int(buf[36]),
        "barrier_withdrawals": int(buf[37]),
        "dedup_replays": int(buf[38]),
        "stale_rejects": int(buf[39]),
        "kv_entries": int(buf[40]),
        "bytes_slots": int(buf[41]),
        "bytes_slot_bytes": int(buf[42]),
        "wal_enqueued": int(buf[43]),
        "wal_acked": int(buf[44]),
        "wal_dropped": int(buf[45]),
        "repl_status": int(buf[46]),
        "repl_applied": int(buf[47]),
        "quorum_acks": int(buf[48]),
        "partition_rejects": int(buf[49]),
        "replica_sources": int(buf[50]),
        "quorum_state": int(buf[51]),
        "repl_targets_live": int(buf[52]),
    }


class ControlPlaneServer:
    """Coordinator side of the scalar control plane (one per job).

    ``secret`` (non-empty) enables the mutual HMAC-SHA256 handshake: every
    connection must prove knowledge of the job's shared secret before any
    op is served. ``max_mailbox_bytes`` caps each deposit mailbox (0 =
    unlimited) so depositors to a dead owner cannot grow server memory
    without bound.
    """

    def __init__(self, world: int, port: int = 0, secret: str = "",
                 max_mailbox_bytes: int = 0,
                 sockbuf_bytes: Optional[int] = None,
                 rejoin_pending: bool = False) -> None:
        lib = load()
        self._lib = lib
        if sockbuf_bytes is None:
            sockbuf_bytes = _env_sockbuf_bytes()
        # rejoin_pending arms the rejoin gate ATOMICALLY with the bind: a
        # restarted shard accepts connections from construction, and not
        # one op may execute against the empty store before the snapshot
        # catch-up lands (set_successor opens the gate). The server reads
        # its lock lease and barrier deadline here.
        with _native_knobs():
            self._h = lib.bf_cp_serve_auth3(port, world, secret.encode(),
                                            int(max_mailbox_bytes),
                                            int(sockbuf_bytes),
                                            1 if rejoin_pending else 0)
        if not self._h:
            raise OSError(f"control plane failed to bind port {port}")
        self.port = lib.bf_cp_server_port(self._h)

    def stop(self) -> None:
        if self._h:
            self._lib.bf_cp_server_stop(self._h)
            self._h = None

    def drop_connections(self) -> None:
        """Fault-injection kill hook: hard-drop every live client
        connection while the server keeps running — what a network
        partition or peer restart looks like from the clients' side.
        Clients with retries enabled reconnect transparently."""
        if self._h:
            self._lib.bf_cp_server_drop_conns(self._h)

    # -- WAL replication / rejoin -------------------------------------------

    def set_successor(self, host: str, port: int, nshards: int = 0,
                      idx: int = -1) -> None:
        """Start streaming this server's mailbox/KV/lock mutations to its
        ring successor (chain commit: client replies wait for the
        successor's ack). ``nshards``/``idx`` give the server its ring
        position — the kSnapshot filter and the scoped incarnation GC key
        off it. One-shot per server."""
        with _native_knobs():
            r = self._lib.bf_cp_server_set_successor(
                self._h, host.encode(), int(port), int(nshards), int(idx))
        if r < 0:
            raise RuntimeError("replication successor already configured")

    def set_successors(self, targets, nshards: int = 0,
                       idx: int = -1) -> None:
        """Quorum generalization of :meth:`set_successor` (R >= 3):
        ``targets`` is a list of ``(shard_idx, host, port)`` naming this
        server's R-1 ring successors. One target degenerates to the legacy
        chain (same thread, same wire — R=2 stays byte-identical); two or
        more arm quorum mode: a dedicated WAL stream per target and the
        ack-from-⌈R/2⌉ commit rule. One-shot per server."""
        spec = ";".join(f"{int(i)}:{h}:{int(p)}" for i, h, p in targets)
        with _native_knobs():
            r = self._lib.bf_cp_server_set_successors(
                self._h, spec.encode(), int(nshards), int(idx))
        if r == -2:
            raise ValueError(f"malformed successor spec {spec!r}")
        if r < 0:
            raise RuntimeError("replication successors already configured")

    def reset_store(self) -> None:
        """Drop the whole store and re-arm the rejoin gate — the guarded
        in-place self-rejoin a shard runs after surviving on the minority
        side of a healed partition: local state may have diverged from
        the quorum, so it rebuilds from replica snapshots like a
        restarted process would, without losing its listener."""
        self._lib.bf_cp_server_reset_store(self._h)

    def rejoin_done(self) -> None:
        """Reopen the rejoin gate after an in-place self-rejoin
        (:meth:`reset_store` + snapshot catch-up): the successor streams
        of a living process are already armed, so the legacy gate-open
        path (``set_successor``, one-shot) never runs again."""
        self._lib.bf_cp_server_rejoin_done(self._h)

    def set_rejoin_pending(self) -> None:
        """Arm the rejoin gate BEFORE pulling a snapshot: incoming WAL
        records park until :meth:`load_snapshot` (with ``set_fence``)
        clears it, so the resumed stream cannot interleave with the
        not-yet-loaded snapshot contents."""
        self._lib.bf_cp_server_set_rejoin_pending(self._h)

    def load_snapshot(self, blob: bytes, set_fence: bool = True,
                      adopt_wal: bool = False, src_idx: int = -2) -> int:
        """Apply a snapshot blob pulled from a peer shard (rejoin
        catch-up); returns the record count applied. ``set_fence`` adopts
        the blob's WAL fence so the predecessor's resumed stream skips
        records already folded into the snapshot — pass it only for a
        blob served by the ring PREDECESSOR (the fence is a position in
        its WAL). ``adopt_wal`` resumes this server's own WAL numbering
        from the fence the serving shard holds against our stream — pass
        it only for a blob served by the ring SUCCESSOR (our stream's
        receiver); restarting at zero would leave every post-rejoin
        record at or below the receiver's stale fence, silently
        dropped-and-acked. ``src_idx`` names WHICH incoming stream the
        fence belongs to under quorum replication — the serving shard's
        ring index (its stream frames carry rank -(100+src_idx)); the
        default -2 is the legacy chain stream."""
        r = int(self._lib.bf_cp_server_load_snapshot2(
            self._h, blob, len(blob), 1 if set_fence else 0,
            1 if adopt_wal else 0, int(src_idx)))
        if r < 0:
            raise RuntimeError("malformed control-plane snapshot blob")
        return r

    # -- introspection (tests assert incarnation GC left nothing) ----------

    def dedup_entries(self) -> int:
        """Server-side op-seq dedup table size (all clients)."""
        return int(self._lib.bf_cp_server_dedup_entries(self._h))

    def mailbox_records_from(self, origin: int) -> int:
        """Queued mailbox records whose deposit tag names ``origin``."""
        return int(self._lib.bf_cp_server_mailbox_from(self._h, origin))

    def incarnation_of(self, rank: int) -> int:
        """Registered incarnation of ``rank`` (-1 = never attached)."""
        return int(self._lib.bf_cp_server_incarnation(self._h, rank))

    _SRV_SLOTS = _SRV_STAT_SLOTS

    def stats(self) -> dict:
        """Server-side telemetry: per-op dispatch counts (zero rows
        suppressed) plus the live aggregates the health plane publishes —
        connection count, queued mailbox depth/bytes, held locks — and the
        fault/recovery event counters (lock force-releases, barrier
        withdrawals, dedup replays, fenced ops)."""
        if not self._h:
            return {}
        buf = (ctypes.c_longlong * self._SRV_SLOTS)()
        if self._lib.bf_cp_server_counters(self._h, buf,
                                           self._SRV_SLOTS) < 0:
            return {}
        return _server_stats_dict(buf)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class ControlPlaneClient:
    """Per-controller client: mutexes, counters, barriers, scalar KV.

    ``streams`` (default ``BFT_CP_STREAMS``, 4) sizes the striped
    connection pool used for large bulk bodies: the primary connection plus
    ``streams - 1`` extra authenticated connections, opened LAZILY on the
    first striped transfer (scalar-only clients — heartbeat, short-lived
    test actors — never pay for them). Each pool connection runs the full
    mutual HMAC handshake. ``streams=1`` is the strict single-connection
    fallback: no pool, and every code path below degrades to the exact
    wire behavior.
    """

    def __init__(self, host: str, port: int, rank: int,
                 secret: str = "", streams: Optional[int] = None,
                 sockbuf_bytes: Optional[int] = None,
                 incarnation: Optional[int] = None) -> None:
        lib = load()
        self._lib = lib
        # the native dialer takes a numeric IPv4 address; torchrun's
        # MASTER_ADDR is often a name ("localhost")
        host = socket.gethostbyname(host)
        self._conn = (host, port, rank, secret)
        self._sockbuf = _env_sockbuf_bytes() if sockbuf_bytes is None \
            else int(sockbuf_bytes)
        self.streams = _env_streams() if streams is None \
            else max(1, int(streams))
        self._stripe_min = _env_stripe_min_bytes()
        self._extra: list = []       # lazily-opened pool connections
        self._pool_mu = threading.Lock()
        # Incarnation fencing: None keeps the legacy unfenced wire (tests,
        # external actors). A registered client — every pool connection
        # included, re-registered on every transparent reconnect — is
        # rejected server-side once its rank attaches with a newer
        # incarnation, surfacing StaleIncarnationError instead of corrupting
        # shared state as a zombie.
        self.incarnation = None if incarnation is None else int(incarnation)
        self._h = self._connect()
        if not self._h:
            raise OSError(
                f"control plane connect to {host}:{port} failed"
                + (" (authentication handshake rejected?)" if secret else ""))
        if self.incarnation is not None:
            self._register(self._h)

    def _connect(self):
        """One authenticated connection (NULL on failure); the client
        reads its retry budget and backoff here."""
        host, port, rank, secret = self._conn
        with _native_knobs():
            return self._lib.bf_cp_connect_auth2(
                host.encode(), port, rank, secret.encode(), self._sockbuf)

    # -- incarnation fencing -----------------------------------------------

    def _stale_message(self) -> str:
        host, port, rank, _ = self._conn
        return (
            f"control plane rank {rank} (incarnation {self.incarnation}) "
            f"was superseded at {host}:{port}: a newer incarnation of this "
            "rank has attached, so this process is a fenced zombie — its "
            "dedup records, queued deposits, and lock holdings were "
            "garbage-collected server-side. Exit instead of retrying; a "
            "legitimate restart must attach with BFT_INCARNATION bumped.")

    def _register(self, handle) -> None:
        r = self._lib.bf_cp_attach(handle, self.incarnation)
        if r == _STALE:
            raise StaleIncarnationError(self._stale_message())
        if r < 0:
            raise OSError("control plane incarnation registration failed "
                          "(connection lost or not authenticated)")

    def _any_stale(self) -> bool:
        if self.incarnation is None:
            return False
        for h in [self._h] + list(self._extra):
            if h and self._lib.bf_cp_is_stale(h):
                return True
        return False

    def _check_stale(self, r: int) -> None:
        """Raise typed when a -4 status is the fence verdict (the native
        layer latches a per-connection flag, so a genuine -4 scalar value
        read from the KV can never be mistaken for it)."""
        if r == _STALE and self._any_stale():
            raise StaleIncarnationError(self._stale_message())

    def _check_quorum(self, r, what: str) -> None:
        """Raise typed when a -5 status is the server's below-quorum
        rejection. Only MUTATING ops are gated server-side, so -5 from
        one of them is unambiguous (reads — which could legitimately
        return a stored -5 — are never gated and never checked)."""
        if r == _QUORUM_LOST:
            host, port, _rank, _ = self._conn
            raise QuorumLostError(
                f"{what}: shard at {host}:{port} is below its commit "
                "quorum (minority side of a partition, or too many "
                "replicas down) and has degraded to READ-ONLY; the "
                "mutation was NOT applied. Retry after the partition "
                "heals.")

    def _wire_error(self, message: str):
        """Map a failed native call to the right exception: typed fence
        verdict when the connection was superseded, plain OSError else."""
        if self._any_stale():
            raise StaleIncarnationError(self._stale_message())
        raise OSError(message)

    # -- striped connection pool -------------------------------------------

    def _pool_handles(self) -> list:
        """All pool connections (primary first), opening extras on demand.

        A failed extra connect degrades the pool width with a log line
        instead of failing the transfer — the primary connection always
        works (we are talking to a live server)."""
        if self.streams <= 1:
            return [self._h]
        with self._pool_mu:
            while len(self._extra) < self.streams - 1:
                host, port, _, _ = self._conn
                h = self._connect()
                if not h:
                    logger.warning(
                        "control plane stripe connection %d/%d to %s:%d "
                        "failed; continuing with a narrower pool",
                        len(self._extra) + 2, self.streams, host, port)
                    self.streams = len(self._extra) + 1
                    break
                if self.incarnation is not None:
                    try:
                        self._register(h)
                    except BaseException:
                        self._lib.bf_cp_disconnect(h)
                        raise
                self._extra.append(h)
            return [self._h] + list(self._extra)

    def _pool_array(self):
        handles = self._pool_handles()
        arr = (ctypes.c_void_p * len(handles))(*handles)
        return arr, len(handles)

    def barrier(self, name: str = "default") -> int:
        r = self._lib.bf_cp_barrier(self._h, name.encode())
        self._check_stale(r)
        if r == _DEAD_HOLDER:
            raise _peer_lost(
                f"barrier '{name}' abandoned: a participant never arrived "
                "within BFT_CP_BARRIER_TIMEOUT (peer crashed or "
                "partitioned)")
        if r < 0:
            raise OSError("control plane barrier failed (connection lost "
                          "or not authenticated)")
        return r

    def lock(self, name: str) -> None:
        r = self._lib.bf_cp_lock(self._h, name.encode())
        self._check_stale(r)
        self._check_quorum(r, f"lock '{name}'")
        if r == _DEAD_HOLDER:
            # the lock was left FREE: after handling the error a fresh
            # acquire succeeds
            raise _peer_lost(
                f"lock '{name}': the holder died while we waited (its "
                "connection closed or its BFT_CP_LOCK_LEASE expired); "
                "the lock was force-released")
        if r < 0:
            raise OSError("control plane lock failed (connection lost "
                          "or not authenticated)")

    def unlock(self, name: str) -> None:
        r = self._lib.bf_cp_unlock(self._h, name.encode())
        self._check_stale(r)
        self._check_quorum(r, f"unlock '{name}'")
        if r == _DEAD_HOLDER:
            raise _peer_lost(
                f"unlock '{name}': this client no longer held the lock — "
                "it was force-released mid-hold (lease expiry or a "
                "connection drop), so the critical section was broken")
        if r < 0:
            raise OSError("control plane unlock failed (connection lost "
                          "or not authenticated)")

    def fetch_add(self, name: str, delta: int = 1) -> int:
        """Atomic fetch-then-add; returns the pre-add value
        (MPI_Fetch_and_op semantics, mpi_controller.cc:1532-1602)."""
        r = self._lib.bf_cp_fetch_add(self._h, name.encode(), delta)
        self._check_stale(r)
        self._check_quorum(r, f"fetch_add '{name}'")
        return r

    def put(self, name: str, value: int) -> None:
        r = self._lib.bf_cp_put(self._h, name.encode(), value)
        self._check_stale(r)
        self._check_quorum(r, f"put '{name}'")
        if r < 0:
            raise OSError("control plane put failed (connection lost "
                          "or not authenticated)")

    def get(self, name: str) -> int:
        r = self._lib.bf_cp_get(self._h, name.encode())
        self._check_stale(r)
        return r

    def put_max(self, name: str, value: int) -> int:
        """Monotone merge: kv[name] = max(kv[name], value); returns the
        post-merge value. The shard router's replication write — replaying
        it (lost reply, failover re-send) can never regress the value."""
        r = self._lib.bf_cp_put_max(self._h, name.encode(), value)
        self._check_stale(r)
        self._check_quorum(r, f"put_max '{name}'")
        return r

    def set_failover(self, host: str, port: int) -> None:
        """Name the ring-successor endpoint this client may permanently
        redirect to when its primary stops answering mid-call. The
        redirect happens INSIDE the native retry loop, so the re-sent
        request keeps its kSeqPre (cid, seq) identity — on a replicated
        shard pair the successor replays the WAL-recorded reply instead
        of double-applying (exactly-once across failover)."""
        self._lib.bf_cp_set_failover(
            self._h, socket.gethostbyname(host).encode(), int(port))

    def set_failover_chain(self, targets) -> None:
        """Multi-hop generalization (quorum replication, R >= 3):
        ``targets`` is a list of ``(host, port)`` ring successors in walk
        order. Reconnect advances past runs of consecutive dead shards,
        sticky on the first entry that answers — the re-sent request
        keeps its (cid, seq) identity, so whichever replica it lands on
        replays the WAL-recorded reply (exactly-once past R-1 deaths)."""
        spec = ",".join(f"{socket.gethostbyname(h)}:{int(p)}"
                        for h, p in targets)
        self._lib.bf_cp_set_failover2(self._h, spec.encode())

    def set_group(self, group: int) -> None:
        """Bind this client to a partition-injector side, overriding the
        process default (in-process multi-server tests and the soak's
        worker pool place each client on its shard's side)."""
        self._lib.bf_cp_client_set_group(self._h, int(group))

    def failed_over(self) -> bool:
        """True once this client permanently redirected past its primary
        (lock-free read — safe next to a blocked op). Under a failover
        CHAIN the underlying native value is the 1-based chain index the
        client stuck to; bool-ness is preserved."""
        return bool(self._lib.bf_cp_failed_over(self._h))

    def snapshot(self, filter_shards: int = 0, filter_idx: int = 0,
                 rearm: bool = False) -> bytes:
        """Pull a point-in-time state snapshot from the connected server
        (kSnapshot; the shard-rejoin catch-up transport). With
        ``filter_shards`` > 0 only keys whose preferred shard
        (fnv64 % filter_shards) equals ``filter_idx`` are included.
        ``rearm`` declares this caller the serving shard's WAL-stream
        RECEIVER catching up: the server resumes its degraded stream
        from this exact cut. Only the rejoin protocol may set it — a
        pull whose caller does not load the cut into the receiving
        replica would turn the degrade-era drop into a silent mid-stream
        gap (diagnostic pulls must leave it False)."""
        arg = ((int(filter_shards) << 32) | (int(filter_idx) & 0xFFFFFFFF)
               if filter_shards else 0) | ((1 << 62) if rearm else 0)
        out = ctypes.c_void_p()
        out_len = ctypes.c_int64()
        r = self._lib.bf_cp_snapshot(self._h, arg, ctypes.byref(out),
                                     ctypes.byref(out_len))
        if r < 0:
            self._wire_error("control plane snapshot pull failed")
        try:
            return ctypes.string_at(out.value, out_len.value) \
                if out_len.value else b""
        finally:
            self._lib.bf_cp_free(out)

    def server_stats(self) -> dict:
        """The server's telemetry counter block, read over the wire (the
        kStats op) — per-shard server views for external actors that do
        not own the :class:`ControlPlaneServer` handle. Empty dict when
        the server predates the op."""
        buf = (ctypes.c_longlong * _SRV_STAT_SLOTS)()
        r = self._lib.bf_cp_remote_stats(self._h, buf, _SRV_STAT_SLOTS)
        if r == _STALE:
            self._check_stale(r)
        if r < _SRV_STAT_SLOTS:
            return {}
        return _server_stats_dict(buf)

    # -- pipelined batches --------------------------------------------------

    def get_many(self, names) -> list:
        """Batched get: n keys, one round-trip's latency."""
        names = list(names)
        if not names:
            return []
        n = len(names)
        out = (ctypes.c_int64 * n)()
        r = self._lib.bf_cp_multi(self._h, OP_CODES["get"], "\n".join(names).encode(),
                                  None, out, n)
        if r < 0:
            self._wire_error("control plane get_many failed")
        return list(out)

    def put_many(self, names, values) -> None:
        """Batched put: n (key, int64) pairs, one round-trip's latency."""
        names = list(names)
        if not names:
            return
        n = len(names)
        args = (ctypes.c_int64 * n)(*[int(v) for v in values])
        out = (ctypes.c_int64 * n)()
        if self._lib.bf_cp_multi(self._h, OP_CODES["put"], "\n".join(names).encode(),
                                 args, out, n) < 0:
            self._wire_error("control plane put_many failed")
        if _QUORUM_LOST in out:
            self._check_quorum(_QUORUM_LOST, "put_many")

    def fetch_add_many(self, names, deltas=None) -> list:
        """Batched fetch_add (default delta 1 each): pre-add values, one
        round-trip's latency — the hosted plane's version-bump hot path."""
        names = list(names)
        if not names:
            return []
        n = len(names)
        args = (ctypes.c_int64 * n)(
            *([1] * n if deltas is None else [int(d) for d in deltas]))
        out = (ctypes.c_int64 * n)()
        if self._lib.bf_cp_multi(self._h, OP_CODES["fetch_add"], "\n".join(names).encode(),
                                 args, out, n) < 0:
            self._wire_error("control plane fetch_add_many failed")
        out = list(out)
        if _QUORUM_LOST in out:
            self._check_quorum(_QUORUM_LOST, "fetch_add_many")
        return out

    # -- bulk bytes: the host tensor transport for one-sided windows --------

    # request framing overhead (header + key) must stay under the server's
    # 1 GiB message ceiling; reject oversized payloads client-side instead of
    # poisoning the connection (the server drops it without replying)
    _MAX_PAYLOAD = (1 << 30) - 4096

    def _check_payload(self, what: str, data: bytes) -> None:
        if len(data) > self._MAX_PAYLOAD:
            raise ValueError(
                f"{what}: payload of {len(data)} bytes exceeds the control "
                f"plane's {self._MAX_PAYLOAD}-byte per-message ceiling; "
                "split the window tensor into smaller leaves")

    def append_bytes(self, name: str, data: bytes) -> int:
        """Append one deposit record to the named server mailbox; returns the
        record count after the append. One-sided: only this client blocks."""
        self._check_payload("append_bytes", data)
        r = self._lib.bf_cp_append_bytes(self._h, name.encode(), data,
                                         len(data))
        self._check_stale(r)
        self._check_quorum(r, f"append_bytes '{name}'")
        if r == -2:
            raise RuntimeError(
                f"control plane mailbox '{name}' is full (server byte cap, "
                "BFT_CP_MAILBOX_MAX_MB) — the owning controller has not "
                "drained it; it may be dead")
        if r < 0:
            raise OSError("control plane append_bytes failed")
        return int(r)

    def take_bytes(self, name: str) -> list:
        """Atomically drain the named mailbox; returns records in deposit
        order (empty list when nothing is pending)."""
        out = ctypes.c_void_p()
        out_len = ctypes.c_int64()
        r = self._lib.bf_cp_take_bytes(self._h, name.encode(),
                                       ctypes.byref(out),
                                       ctypes.byref(out_len))
        self._check_quorum(r, f"take_bytes '{name}'")
        if r < 0:
            self._wire_error("control plane take_bytes failed")
        try:
            payload = ctypes.string_at(out.value, out_len.value) \
                if out_len.value else b""
        finally:
            self._lib.bf_cp_free(out)
        records = []
        off = 0
        while off < len(payload):
            (rl,) = struct.unpack_from("<I", payload, off)
            off += 4
            records.append(payload[off:off + rl])
            off += rl
        return records

    # op codes for the pipelined bytes batches — single source of truth is
    # runtime/protocol.py (mirroring csrc/bf_runtime.cc enum Op; bfcheck
    # asserts the bijection)
    _OP_APPEND_BYTES = OP_CODES["append_bytes"]
    _OP_TAKE_BYTES = OP_CODES["take_bytes"]
    _OP_PUT_BYTES = OP_CODES["put_bytes"]
    _OP_GET_BYTES = OP_CODES["get_bytes"]
    _OP_APPEND_BYTES_TAGGED = OP_CODES["append_bytes_tagged"]

    def _bytes_multi_out(self, op: int, names, blobs, tags=None,
                         handle=None) -> list:
        """Records may be ``bytes`` or any C-contiguous buffer (numpy
        views): payloads are passed by POINTER to the native scatter-gather
        write, so a 100 MB deposit costs zero Python-side copies.
        ``handle`` selects a pool connection (default: the primary)."""
        names = list(names)
        blobs = list(blobs)  # may be a generator; it's iterated twice below
        if not names:
            return []
        if handle is None:
            handle = self._h
        n = len(names)
        ptrs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_int64 * n)()
        keep = []  # keeps the buffers' owners alive across the call
        for i, b in enumerate(blobs):
            if isinstance(b, (bytes, bytearray)):
                self._check_payload(f"bytes batch '{names[i]}'", b)
                cb = ctypes.c_char_p(bytes(b))
                keep.append(cb)
                ptrs[i] = ctypes.cast(cb, ctypes.c_void_p).value
                lens[i] = len(b)
            else:  # buffer protocol (numpy array/view)
                mv = memoryview(b)
                if not mv.c_contiguous:
                    raise ValueError("bytes batch payloads must be "
                                     "C-contiguous")
                nbytes = mv.nbytes
                if nbytes > self._MAX_PAYLOAD:
                    raise ValueError(
                        f"bytes batch '{names[i]}': payload of {nbytes} "
                        f"bytes exceeds the {self._MAX_PAYLOAD}-byte "
                        "per-message ceiling")
                if mv.readonly:  # rare: fall back to one copy
                    cb = ctypes.c_char_p(mv.tobytes())
                    keep.append(cb)
                    ptrs[i] = ctypes.cast(cb, ctypes.c_void_p).value
                else:
                    flat = mv.cast("B") if nbytes else mv
                    keep.append(flat)
                    ptrs[i] = ctypes.addressof(
                        ctypes.c_char.from_buffer(flat)) if nbytes else 0
                lens[i] = nbytes
        out = (ctypes.c_int64 * n)()
        if tags is None:
            r = self._lib.bf_cp_bytes_multi_outv(
                handle, op, "\n".join(names).encode(), ptrs, lens, out, n)
        else:
            tag_arr = (ctypes.c_int64 * n)(*[int(t) for t in tags])
            r = self._lib.bf_cp_bytes_multi_outv_tagged(
                handle, op, "\n".join(names).encode(), ptrs, lens,
                tag_arr, out, n)
        self._check_quorum(r, "bytes batch")
        if r < 0:
            self._wire_error("control plane bytes batch failed (connection "
                             "lost or not authenticated)")
        out = list(out)
        if _STALE in out:
            self._check_stale(_STALE)
        if _QUORUM_LOST in out:
            # a below-quorum server rejects EVERY entry of a gated batch,
            # so one -5 entry means the whole mutation batch was refused
            self._check_quorum(_QUORUM_LOST, "bytes batch")
        return out

    def _bytes_multi_in_raw(self, op: int, names,
                            handle=None) -> NativeReply:
        """One pipelined bulk-reply batch; the (u64 len | payload)* reply
        stays in the native buffer, exposed as a zero-copy view."""
        n = len(names)
        out = ctypes.c_void_p()
        out_len = ctypes.c_int64()
        r = self._lib.bf_cp_bytes_multi_in(
                self._h if handle is None else handle, op,
                "\n".join(names).encode(), n,
                ctypes.byref(out), ctypes.byref(out_len))
        self._check_quorum(r, "bulk drain")  # take_bytes batches are gated
        if r < 0:
            self._wire_error("control plane bytes batch failed (connection "
                             "lost or not authenticated)")
        return NativeReply(self._lib, out, out_len.value)

    def _bytes_multi_in(self, op: int, names) -> list:
        names = list(names)
        if not names:
            return []
        with self._bytes_multi_in_raw(op, names) as reply:
            payload = reply.view
            blobs = []
            off = 0
            for _ in range(len(names)):
                (ln,) = struct.unpack_from("<Q", payload, off)
                off += 8
                blobs.append(bytes(payload[off:off + ln]))
                off += ln
        return blobs

    def append_bytes_many(self, names, blobs) -> list:
        """Pipelined multi-append: n deposit records, one round-trip's
        latency (the hosted window data plane's wire discipline — the
        analog of the reference's chunked MPI_Put stream,
        mpi_controller.cc:932-1034). Returns per-record post-append counts;
        -2 entries mean that mailbox hit the server byte cap."""
        return self._bytes_multi_out(self._OP_APPEND_BYTES, names, blobs)

    def append_bytes_tagged_many(self, names, blobs, tags) -> list:
        """Like :meth:`append_bytes_many`, but each record's int64 tag is
        prefixed to the stored record server-side (kAppendBytesTagged).
        The window drain uses the tag — (sequence id, chunk index, chunk
        count) — to discard orphaned continuation chunks after a
        concurrent clear instead of misparsing them as headers.

        With a striped pool (``streams > 1``) and a large enough batch,
        the deposit HEADER records (tag index 0) go out first on the
        primary connection, then the payload chunk records stripe
        round-robin across the whole pool and transfer concurrently. The
        header-before-chunks server arrival order is what lets the drain
        treat a header-less chunk as a definitively orphaned deposit (a
        concurrent clear ate its prefix) rather than an early arrival;
        chunk-vs-chunk order is free because chunk tags carry their index
        and the drain places them by offset."""
        names, blobs, tags = list(names), list(blobs), list(tags)
        if (self.streams > 1 and len(names) > 1
                and sum(_blob_len(b) for b in blobs) >= self._stripe_min):
            return self._striped_append_tagged(names, blobs, tags)
        return self._bytes_multi_out(self._OP_APPEND_BYTES_TAGGED, names,
                                     blobs, tags=tags)

    def _striped_append_tagged(self, names, blobs, tags) -> list:
        op = self._OP_APPEND_BYTES_TAGGED
        hdr = [i for i, t in enumerate(tags) if (int(t) & 0xFFFFFF) == 0]
        chunk = [i for i, t in enumerate(tags) if (int(t) & 0xFFFFFF) != 0]
        out = [0] * len(names)

        def scatter(idxs, replies):
            for i, r in zip(idxs, replies):
                out[i] = r

        if hdr:  # phase 1: all headers, appended before any chunk streams
            scatter(hdr, self._bytes_multi_out(
                op, [names[i] for i in hdr], [blobs[i] for i in hdr],
                tags=[tags[i] for i in hdr]))
        if chunk:  # phase 2: chunks round-robin over the pool, concurrent
            pool = self._pool_handles()
            ngroups = min(len(pool), len(chunk))
            groups = [chunk[g::ngroups] for g in range(ngroups)]
            replies = _run_parallel([
                lambda h=pool[g], idxs=groups[g]: self._bytes_multi_out(
                    op, [names[i] for i in idxs], [blobs[i] for i in idxs],
                    tags=[tags[i] for i in idxs], handle=h)
                for g in range(ngroups)])
            for g in range(ngroups):
                scatter(groups[g], replies[g])
        return out

    def put_bytes_many(self, names, blobs) -> None:
        """Pipelined multi-put of bytes slots (batched self publishes).

        Bodies at or above the stripe threshold transfer as concurrent
        byte-range stripes over the connection pool (each body saturates
        the pool in turn); smaller ones ride one pipelined batch on the
        primary connection, exactly as before."""
        names, blobs = list(names), list(blobs)
        small_idx, large_idx = [], []
        for i, b in enumerate(blobs):
            (large_idx if self.streams > 1
             and _blob_len(b) >= self._stripe_min else small_idx).append(i)
        for i in large_idx:
            self._put_bytes_striped(names[i], blobs[i])
        if small_idx:
            for r in self._bytes_multi_out(
                    self._OP_PUT_BYTES, [names[i] for i in small_idx],
                    [blobs[i] for i in small_idx]):
                if r < 0:
                    self._check_stale(r)
                    self._check_quorum(r, "put_bytes_many")
                    raise OSError("control plane put_bytes_many failed")

    def _put_bytes_striped(self, name: str, blob) -> None:
        # zero-copy pointer extraction, same discipline as _bytes_multi_out
        if isinstance(blob, (bytes, bytearray)):
            keep = ctypes.c_char_p(bytes(blob))
            ptr = ctypes.cast(keep, ctypes.c_void_p)
            nbytes = len(blob)
        else:
            mv = memoryview(blob).cast("B")
            if mv.readonly:
                keep = ctypes.c_char_p(mv.tobytes())
                ptr = ctypes.cast(keep, ctypes.c_void_p)
            else:
                keep = mv
                ptr = ctypes.c_void_p(ctypes.addressof(
                    ctypes.c_char.from_buffer(mv)) if mv.nbytes else 0)
            nbytes = mv.nbytes
        if nbytes > self._MAX_PAYLOAD:
            raise ValueError(
                f"put_bytes: payload of {nbytes} bytes exceeds the "
                f"{self._MAX_PAYLOAD}-byte per-message ceiling")
        arr, nh = self._pool_array()
        r = self._lib.bf_cp_put_bytes_striped(arr, nh, name.encode(),
                                              ptr, nbytes)
        del keep
        self._check_quorum(r, f"striped put_bytes '{name}'")
        if r < 0:
            self._wire_error("control plane striped put_bytes failed "
                             "(connection lost or not authenticated)")

    @staticmethod
    def _parse_take_reply(payload) -> list:
        records = []
        off = 0
        while off < len(payload):
            (rl,) = struct.unpack_from("<I", payload, off)
            off += 4
            records.append(payload[off:off + rl])
            off += rl
        return records

    def take_bytes_many(self, names) -> list:
        """Pipelined multi-drain: per-key record lists, one round-trip's
        latency. Each key's drain is individually atomic and bounded by the
        server's per-reply cap, exactly like take_bytes."""
        out = []
        for payload in self._bytes_multi_in(self._OP_TAKE_BYTES, names):
            out.append(self._parse_take_reply(payload))
        return out

    @staticmethod
    def _parse_multi_in(payload, n) -> list:
        out = []
        off = 0
        for _ in range(n):
            (ln,) = struct.unpack_from("<Q", payload, off)
            off += 8
            out.append(ControlPlaneClient._parse_take_reply(
                payload[off:off + ln]))
            off += ln
        return out

    def take_bytes_many_views(self, names, pooled: bool = True):
        """Zero-copy multi-drain: ``(per-key record lists, owner)``.

        Records are memoryview slices aliasing the native reply buffers —
        a 100+ MB drain is parsed without the full-payload copies
        :meth:`take_bytes_many` pays (``string_at`` + per-record bytes
        slices). The caller must finish consuming every record view and
        then ``owner.close()`` (use as a context manager); this is the
        hosted window drain's hot path.

        With a striped pool (and ``pooled=True``) the keys split
        round-robin across the connections and every sub-drain streams
        concurrently — the win_update per-in-neighbor sweep issues on the
        whole pool at once instead of serializing source after source.
        Each key is still drained by exactly one connection per sweep, so
        per-key record order is preserved. ``pooled=False`` keeps the
        sweep on one pipelined connection — callers pass it when the
        expected haul is small (a pooled sweep's extra round-trips and
        threads cost more than they parallelize there; the window drain
        adapts per round on the previous round's byte count)."""
        names = list(names)
        if not names:
            return [], NativeReply(self._lib, ctypes.c_void_p(), 0)
        pool = self._pool_handles() if pooled and self.streams > 1 \
            and len(names) > 1 else [self._h]
        if len(pool) == 1:
            owner = self._bytes_multi_in_raw(self._OP_TAKE_BYTES, names)
            return self._parse_multi_in(owner.view, len(names)), owner
        ngroups = min(len(pool), len(names))
        groups = [list(range(g, len(names), ngroups))
                  for g in range(ngroups)]
        owners = _run_parallel([
            lambda h=pool[g], idxs=groups[g]: self._bytes_multi_in_raw(
                self._OP_TAKE_BYTES, [names[i] for i in idxs], handle=h)
            for g in range(ngroups)])
        out = [None] * len(names)
        for g in range(ngroups):
            for i, recs in zip(groups[g], self._parse_multi_in(
                    owners[g].view, len(groups[g]))):
                out[i] = recs
        return out, _MultiReply(owners)

    def get_bytes_many(self, names) -> list:
        """Pipelined multi-read of bytes slots (batched win_get pulls)."""
        return self._bytes_multi_in(self._OP_GET_BYTES, names)

    def box_bytes_many(self, names) -> list:
        """Pipelined read of pending payload bytes per mailbox — the
        origin-side pre-check that keeps a multi-record deposit from being
        torn by the server byte cap (safe: each deposit mailbox has exactly
        one writer, and the owner's drain only shrinks it)."""
        names = list(names)
        if not names:
            return []
        n = len(names)
        out = (ctypes.c_int64 * n)()
        if self._lib.bf_cp_multi(self._h, OP_CODES["box_bytes"], "\n".join(names).encode(),
                                 None, out, n) < 0:
            self._wire_error("control plane box_bytes_many failed")
        return list(out)

    def put_bytes(self, name: str, data: bytes) -> None:
        """Overwrite the named bytes slot (the 'exposed window' copy).
        Large bodies stripe across the connection pool (readers only ever
        observe complete values: stripes assemble server-side and swap in
        atomically)."""
        if self.streams > 1 and _blob_len(data) >= self._stripe_min:
            return self._put_bytes_striped(name, data)
        self._check_payload("put_bytes", data)
        r = self._lib.bf_cp_put_bytes(self._h, name.encode(), data,
                                      len(data))
        self._check_quorum(r, f"put_bytes '{name}'")
        if r < 0:
            self._wire_error("control plane put_bytes failed")

    def bytes_len(self, name: str) -> int:
        """Current byte length of the named bytes slot (0 when never put)."""
        r = self._lib.bf_cp_bytes_len(self._h, name.encode())
        if r < 0:
            self._wire_error("control plane bytes_len failed")
        return int(r)

    def get_bytes_view(self, name: str):
        """Read a bytes slot as ``(memoryview, owner)`` with zero Python
        copies; large bodies are fetched as concurrent byte-range stripes
        over the pool. The caller consumes the view, then ``owner.close()``
        (the win_get hot path)."""
        if self.streams > 1:
            ln = self.bytes_len(name)
            if ln >= self._stripe_min:
                arr, nh = self._pool_array()
                out = ctypes.c_void_p()
                out_len = ctypes.c_int64()
                if self._lib.bf_cp_get_bytes_striped(
                        arr, nh, name.encode(), ctypes.byref(out),
                        ctypes.byref(out_len)) < 0:
                    self._wire_error("control plane striped get_bytes "
                                     "failed (connection lost or value "
                                     "churning)")
                owner = NativeReply(self._lib, out, out_len.value)
                return owner.view, owner
        owner = self._bytes_multi_in_raw(self._OP_GET_BYTES, [name])
        (ln,) = struct.unpack_from("<Q", owner.view, 0)
        return owner.view[8:8 + ln], owner

    def get_bytes(self, name: str) -> bytes:
        """Read the named bytes slot (empty when never put)."""
        if self.streams > 1 and \
                self.bytes_len(name) >= self._stripe_min:
            view, owner = self.get_bytes_view(name)
            try:
                return bytes(view)
            finally:
                owner.close()
        out = ctypes.c_void_p()
        out_len = ctypes.c_int64()
        r = self._lib.bf_cp_get_bytes(self._h, name.encode(),
                                      ctypes.byref(out),
                                      ctypes.byref(out_len))
        if r < 0:
            self._wire_error("control plane get_bytes failed")
        try:
            return ctypes.string_at(out.value, out_len.value) \
                if out_len.value else b""
        finally:
            self._lib.bf_cp_free(out)

    def close(self) -> None:
        with self._pool_mu:
            for h in self._extra:
                self._lib.bf_cp_disconnect(h)
            self._extra = []
        if self._h:
            self._lib.bf_cp_disconnect(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
