"""The port's knob registry: every environment knob it reads.

Counterpart of the registry in ``bluefog_tpu/runtime/config.py``
(:79-655). The port reads its knobs under its own ``BFT_`` prefix, so a job
that runs both packages on one host configures each apart; every knob
records the ``BLUEFOG_*`` knob of the JAX package it stands for
(``jax_name``) and keeps that knob's default. Only the knobs the port reads
are declared. ``tests/test_torch_port_knobs.py`` walks the port's sources
and fails on a read of an undeclared ``BFT_*`` or ``BLUEFOG_*`` name, or on
a read whose literal default differs from the registry's.

The port's launcher environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``LOCAL_WORLD_SIZE``, ``LOCAL_RANK``) and ``CUDA_HOME`` are not knobs of the
package: they come from ``torchrun`` and the CUDA toolkit.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Knob:
    """One declared environment knob.

    ``type`` is one of ``int``/``float``/``str``/``bool``/``path``/``spec``
    (``bool`` knobs are the ``"0"``/``"1"`` convention; ``spec`` is a
    grammar of its own). ``default`` is the typed default (None = unset:
    the site decides). ``jax_name`` is the JAX package's knob this one
    stands for. ``scope`` is ``native`` for the knobs the native library
    (``csrc/bf_runtime.cc``) reads itself, under their ``jax_name``:
    ``runtime/native.py`` hands it the ``BFT_*`` value under that name.
    """

    name: str
    type: str
    default: object
    doc: str
    jax_name: str
    scope: str = "python"


KNOBS: Tuple[Knob, ...] = (
    Knob("BFT_LOG_LEVEL", "str", "warn",
         "trace / debug / info / warn / error / fatal",
         "BLUEFOG_LOG_LEVEL"),
    Knob("BFT_LOG_HIDE_TIME", "bool", False,
         "`1` hides timestamps in log lines", "BLUEFOG_LOG_HIDE_TIME"),
    Knob("BFT_TIMELINE", "path", None,
         "path prefix → enable the chrome-tracing timeline at `bf.init` "
         "(one file `<prefix><rank>.json` per process)",
         "BLUEFOG_TIMELINE"),
    Knob("BFT_METRICS_INTERVAL", "float", None,
         "seconds between metrics publications (the Prometheus file; the "
         "timeline's counter tracks). Unset/0 disables publication — "
         "collection is always on",
         "BLUEFOG_METRICS_INTERVAL"),
    Knob("BFT_METRICS_PROM", "path", None,
         "path of a Prometheus text-exposition file, rewritten atomically "
         "on the metrics cadence (implies a 10 s cadence when "
         "`BFT_METRICS_INTERVAL` is unset). In a job of more than one rank "
         "each rank writes `<root>.<rank><ext>` (`scrape.prom` -> "
         "`scrape.3.prom`)", "BLUEFOG_METRICS_PROM"),
    Knob("BFT_STRAGGLER_STEPS", "int", 3,
         "step-counter spread at which the health view flags a rank as a "
         "straggler", "BLUEFOG_STRAGGLER_STEPS"),
    Knob("BFT_FLIGHT_CAPACITY", "int", 8192,
         "event capacity of the always-on flight-recorder ring; rounded up "
         "to a power of two", "BLUEFOG_FLIGHT_CAPACITY"),
    Knob("BFT_FLIGHT_DIR", "path", None,
         "directory flight-recorder dumps (`bf_flight_<rank>.json`) are "
         "written to; default: the current working directory",
         "BLUEFOG_FLIGHT_DIR"),
    Knob("BFT_FLIGHT_DISABLE", "bool", False,
         "`1` turns flight recording off entirely",
         "BLUEFOG_FLIGHT_DISABLE"),
    Knob("BFT_FLIGHT_MIN_INTERVAL", "float", 30.0,
         "rate limit (seconds) between automatic flight dumps (fatal "
         "optimizer steps); an explicit `bf.flight_dump()` bypasses it",
         "BLUEFOG_FLIGHT_MIN_INTERVAL"),
    # -- the control plane (runtime/control_plane.py, native.py, router.py,
    #    shard_server.py) --------------------------------------------------
    Knob("BFT_CP_HOST", "str", None,
         "control-plane server host (with `BFT_CP_PORT`: the forced form); "
         "unset, a `torchrun` world of more than one rank derives it from "
         "`MASTER_ADDR`", "BLUEFOG_CP_HOST"),
    Knob("BFT_CP_PORT", "int", None,
         "control-plane server port (default: `MASTER_PORT` + 17)",
         "BLUEFOG_CP_PORT"),
    Knob("BFT_CP_RANK", "int", 0,
         "this process's control-plane rank when `BFT_CP_WORLD` is set "
         "(default: its rank in the process group)", "BLUEFOG_CP_RANK"),
    Knob("BFT_CP_WORLD", "int", 0,
         "number of processes in the job (0 = the process group's size)",
         "BLUEFOG_CP_WORLD"),
    Knob("BFT_CP_SHARDS", "int", 1,
         "shard the control plane across N servers on ports PORT..PORT+N-1, "
         "all served by rank 0; clients route each key by a stable hash "
         "and fail over along the shard ring", "BLUEFOG_CP_SHARDS"),
    Knob("BFT_CP_HOSTS", "str", None,
         "explicit `HOST:PORT,HOST:PORT,...` endpoints of external shard "
         "servers (`python bluefog_tpu_torch/runtime/shard_server.py`); "
         "overrides `BFT_CP_HOST`/`PORT`/`SHARDS`", "BLUEFOG_CP_HOSTS"),
    Knob("BFT_CP_SERVE", "bool", True,
         "`0` stops rank 0 from serving (another process owns the server)",
         "BLUEFOG_CP_SERVE"),
    Knob("BFT_CP_DISABLE", "bool", False,
         "`1` turns the control plane off entirely", "BLUEFOG_CP_DISABLE"),
    Knob("BFT_CP_CONNECT_TIMEOUT", "float", 30.0,
         "seconds `bf.init` retries the control-plane connect before a job "
         "of more than one process fails", "BLUEFOG_CP_CONNECT_TIMEOUT"),
    Knob("BFT_CP_SECRET", "str", None,
         "shared secret of the mutual HMAC-SHA256 connection handshake; "
         "unset = unauthenticated", "BLUEFOG_CP_SECRET"),
    Knob("BFT_CP_RETRIES", "int", 3,
         "reconnect attempts per control-plane op after a wire failure; "
         "`0` fails fast", "BLUEFOG_CP_RETRIES", scope="native"),
    Knob("BFT_CP_BACKOFF_MS", "int", 50,
         "initial reconnect backoff, doubling per attempt, capped at 2 s",
         "BLUEFOG_CP_BACKOFF_MS", scope="native"),
    Knob("BFT_CP_LOCK_LEASE", "float", 60.0,
         "seconds a control-plane lock may be held before a waiter may "
         "force-release it (`PeerLostError`); read by the server at start",
         "BLUEFOG_CP_LOCK_LEASE", scope="native"),
    Knob("BFT_CP_BARRIER_TIMEOUT", "float", 600.0,
         "seconds a control-plane barrier waits for stragglers before "
         "waking every waiter with `PeerLostError`; read by the server at "
         "start", "BLUEFOG_CP_BARRIER_TIMEOUT", scope="native"),
    Knob("BFT_CP_REPL_TIMEOUT", "float", 30.0,
         "seconds a shard server waits for its ring successor's WAL ack "
         "before degrading to unreplicated", "BLUEFOG_CP_REPL_TIMEOUT",
         scope="native"),
    Knob("BFT_CP_WAL_DEPTH", "int", 65536,
         "record cap of a shard server's WAL replication queue",
         "BLUEFOG_CP_WAL_DEPTH", scope="native"),
    Knob("BFT_CP_REPLICATION", "int", 1,
         "copies of every acked record on a sharded control plane: `0` "
         "unreplicated, `1`/`2` the ring-successor chain, `R>=3` quorum",
         "BLUEFOG_CP_REPLICATION"),
    Knob("BFT_CP_REJOIN_TIMEOUT", "float", 30.0,
         "seconds a restarted shard server (`--rejoin`) retries its "
         "snapshot catch-up", "BLUEFOG_CP_REJOIN_TIMEOUT"),
    Knob("BFT_CP_FAULT", "spec", None,
         "testing only: deterministic fault injection, "
         "`drop_after=N,delay_ms=M,trunc=0|1,seed=S`, "
         "`delay_edges=src>dst:ms;...`, `partition=0,1|2,3[,part_after=S]"
         "[,heal_after=S]`", "BLUEFOG_CP_FAULT"),
    Knob("BFT_CP_MAILBOX_MAX_MB", "float", 256.0,
         "per-mailbox byte cap on the control-plane server",
         "BLUEFOG_CP_MAILBOX_MAX_MB"),
    Knob("BFT_CP_STREAMS", "int", 4,
         "width of each client's striped connection pool (1-16); `1` keeps "
         "every byte on one connection", "BLUEFOG_CP_STREAMS"),
    Knob("BFT_CP_STRIPE_MIN_MB", "float", 4.0,
         "bulk payloads at or above this many MB stripe across the pool",
         "BLUEFOG_CP_STRIPE_MIN_MB"),
    Knob("BFT_CP_SOCKBUF_MB", "float", 0.0,
         "explicit `SO_SNDBUF`/`SO_RCVBUF` of control-plane sockets at both "
         "ends; `0` keeps the kernel's auto-tuned buffers",
         "BLUEFOG_CP_SOCKBUF_MB"),
    Knob("BFT_INCARNATION", "int", 0,
         "this process's membership incarnation, registered with the "
         "control plane at attach; a restarted rank attaches with the "
         "previous value + 1, which fences its predecessor",
         "BLUEFOG_INCARNATION"),
    Knob("BFT_NATIVE_SO", "path", None,
         "path of a prebuilt native control-plane library to load instead "
         "of building `csrc/bf_runtime.cc` into `bluefog_tpu_torch/_build/`",
         "BLUEFOG_NATIVE_SO"),
    # -- the window layer (ops/windows.py, ops/codec.py) ---------------------
    Knob("BFT_WIN_PLANE", "str", None,
         "window gossip plane policy: `auto` (default: the hosted mailbox "
         "plane when a control plane of more than one controller is "
         "attached; else the collective plane), `compiled` (collective "
         "plane forced: one lockstep point-to-point round per circulant "
         "shift), `hosted` (mailbox plane forced)", "BLUEFOG_WIN_PLANE"),
    Knob("BFT_WIN_CODEC", "str", None,
         "wire codec of hosted-window deposits: `none` (default, the raw "
         "wire), `int8` / `fp8` (per-block-scaled quantization; also "
         "applied to the collective plane's blend) or `topk:<frac>` (top-k "
         "with an error-feedback residual; `topk` = `topk:0.01`). Per-edge "
         "overrides append `;<src>><dst>=<spec>` terms. Read once per "
         "window at `win_create`", "BLUEFOG_WIN_CODEC"),
    Knob("BFT_WIN_CODEC_BLOCK", "int", 4096,
         "elements per quantization block of the `int8`/`fp8` codecs (the "
         "block size rides the payload, so origin and owner may differ)",
         "BLUEFOG_WIN_CODEC_BLOCK"),
    Knob("BFT_WIN_STRICT", "bool", False,
         "`1`: a `require_mutex` `win_update` raises when it drains a "
         "deposit whose version counter is 0 (an origin skipped the mutex "
         "protocol) instead of folding it", "BLUEFOG_WIN_STRICT"),
    Knob("BFT_WIN_DRAIN_TIMEOUT", "float", 60.0,
         "seconds a `win_update` drain waits for the continuation chunks "
         "of a deposit before raising (the origin died mid-deposit)",
         "BLUEFOG_WIN_DRAIN_TIMEOUT"),
    Knob("BFT_MAX_WIN_SENT_LENGTH", "int", 16 * 1024 * 1024,
         "hosted-window deposit chunk size in BYTES (the reference counted "
         "elements); values below 64 KiB are clamped to it with a warning",
         "BLUEFOG_MAX_WIN_SENT_LENGTH"),
    # -- failure detection (runtime/heartbeat.py, watchdog.py, handles.py,
    #    ops/neighbors.py) ---------------------------------------------------
    Knob("BFT_HEARTBEAT_INTERVAL", "float", 5.0,
         "seconds between controller heartbeats (jobs of more than one "
         "process on a control plane)", "BLUEFOG_HEARTBEAT_INTERVAL"),
    Knob("BFT_HEARTBEAT_TIMEOUT", "float", 30.0,
         "silent-peer threshold: after this many seconds a controller lands "
         "in `bf.dead_controllers()`", "BLUEFOG_HEARTBEAT_TIMEOUT"),
    Knob("BFT_SHUTDOWN_GRACE", "float", None,
         "how long `bf.shutdown()` waits for peers to ack the coordinated "
         "shutdown flag (default 3x the heartbeat interval)",
         "BLUEFOG_SHUTDOWN_GRACE"),
    Knob("BFT_SYNC_TIMEOUT", "float", None,
         "default deadline (seconds) of `bf.synchronize`/`bf.wait`: on "
         "expiry raise with the failure detector's diagnosis (dead peers "
         "named) instead of waiting on", "BLUEFOG_SYNC_TIMEOUT"),
    Knob("BFT_TOPO_CHECK_TIMEOUT", "float", 30.0,
         "seconds the cross-controller dynamic-topology hash rendezvous "
         "waits before declaring divergence", "BLUEFOG_TOPO_CHECK_TIMEOUT"),
    Knob("BFT_TOPO_CHECK_REARM", "int", 50,
         "every K topology-checked dynamic steps the rendezvous runs again "
         "at a server-assigned round (`0` disables); set it identically on "
         "every controller", "BLUEFOG_TOPO_CHECK_REARM"),
    Knob("BFT_CYCLE_TIME", "float", 0.5,
         "ms; poll cadence of the stall watchdog thread (floored at 1 s)",
         "BLUEFOG_CYCLE_TIME"),
    Knob("BFT_STALL_WARNING_TIME", "float", 60.0,
         "seconds an outstanding handle may stay unfinished before the "
         "watchdog warns about it (once)", "BLUEFOG_STALL_WARNING_TIME"),
    # -- the live telemetry plane (runtime/timeseries.py, tuner.py) ---------
    Knob("BFT_TS_INTERVAL", "float", None,
         "seconds between time-series publications (`bf.ts.<rank>`); unset: "
         "the `BFT_METRICS_INTERVAL` cadence, else 5 s; `0` never "
         "publishes (sampling stays on)", "BLUEFOG_TS_INTERVAL"),
    Knob("BFT_TS_DISABLE", "bool", False,
         "`1` turns the time-series plane (ring history, per-edge "
         "estimators, alert rules) off", "BLUEFOG_TS_DISABLE"),
    Knob("BFT_ALERT_RULES", "spec", None,
         "override or extend the alert rules, comma-separated "
         "`name:series>value:for=SEC` terms (`name:off` disables a default)",
         "BLUEFOG_ALERT_RULES"),
    Knob("BFT_SLO", "spec", None,
         "serving SLO declarations, comma-separated `kind:target@window` "
         "terms (`serve_p99:50ms@5m`, `serve_avail:99.9@1h`, ...); unset "
         "disables the SLO engine", "BLUEFOG_SLO"),
    Knob("BFT_SLO_BURN", "float", 2.0,
         "burn-rate threshold of an SLO alert (both the fast and the 12x "
         "slow window must burn faster than this)", "BLUEFOG_SLO_BURN"),
    Knob("BFT_TUNE", "bool", False,
         "`1` turns on the rank-local performance controller (codec "
         "escalation, plane floor, straggler demotion); `0` takes no KV "
         "reads and changes nothing", "BLUEFOG_TUNE"),
    Knob("BFT_TUNE_INTERVAL", "float", 5.0,
         "seconds between controller ticks when `BFT_TUNE=1` (floored at "
         "0.5 s; the tick rides the heartbeat and sampler)",
         "BLUEFOG_TUNE_INTERVAL"),
    Knob("BFT_TUNE_RULES", "spec", None,
         "override the controller's thresholds, comma-separated "
         "`key=value` terms (`slow_ratio`, `min_bps`, `transit_p99_ms`, "
         "`slow_for`, `straggler_for`, `dwell`, `deesc_norm`, `keep_in`)",
         "BLUEFOG_TUNE_RULES"),
)

_KNOB_INDEX = {k.name: k for k in KNOBS}


def knob(name: str) -> Knob:
    """The declared :class:`Knob` for ``name`` (KeyError if undeclared)."""
    return _KNOB_INDEX[name]


def knob_default(name: str):
    """The registry's default for ``name``."""
    return _KNOB_INDEX[name].default


def knob_env(name: str):
    """Read ``name`` from the environment, typed per its declaration.

    Returns the registry default when unset (None for unset knobs); raises
    KeyError for an undeclared name. A malformed value falls back to the
    default rather than raising, as in the JAX package.
    """
    k = _KNOB_INDEX[name]
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return k.default
    try:
        if k.type == "int":
            return int(raw)
        if k.type == "float":
            return float(raw)
        if k.type == "bool":
            return raw == "1"
    except ValueError:
        return k.default
    return raw
