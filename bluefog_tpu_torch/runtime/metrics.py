"""Metrics registry, its packed snapshot, Prometheus text and the health view.

Counterpart of ``bluefog_tpu/runtime/metrics.py``:

* **Registry**: process-global counters, gauges and fixed-bucket
  histograms. A counter increment is one attribute add on a ``__slots__``
  object; a race between threads can at worst drop a rare increment, the
  right trade for telemetry. Collection is always on.
* **Packed snapshot** (``BFM1``): the JAX package's wire format byte for
  byte, so either package reads the other's snapshots.
* **Publication** on the ``BFT_METRICS_INTERVAL`` cadence (10 s when only
  ``BFT_METRICS_PROM`` is set), from a small cadence thread that
  ``bf.init`` starts: the Prometheus text exposition rewritten by atomic
  rename at ``BFT_METRICS_PROM`` (one file per rank in a world of more
  than one, :func:`prom_path`), the packed snapshot under
  ``bf.metrics.<rank>`` in the control plane's KV with the world size
  under ``bf.metrics.world``, and the gauges mirrored onto the timeline's
  counter tracks.
* **Native counters**: with a control plane attached, a snapshot merges
  the native transport's counters (per-op counts and bytes, redials,
  striped transfers, the fault injector's counts) as deltas since the
  job's start, and on the serving rank the server's counter block.
* **Health**: :func:`health_from_snapshots` merges per-rank snapshots
  (staleness, stragglers by step-counter spread, push-sum mass) and
  :func:`format_health` renders it; :func:`cluster_health` reads every
  rank's published snapshot from inside the job, and
  :func:`read_cluster_health` from any raw client, inside or outside it.
"""

from __future__ import annotations

import bisect
import os
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .config import knob_env
from .logging import logger

# -- instruments -------------------------------------------------------------

# Default latency buckets (seconds), the JAX package's.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0,
                   10.0, 30.0)


class Counter:
    """Monotonic counter. ``inc`` is the hot path: one attribute add, no
    lock, no allocation."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str) -> None:
        self.name = name
        self._v = 0

    def inc(self, n: int = 1) -> None:
        self._v += n

    @property
    def value(self) -> int:
        return self._v

    def _reset(self) -> None:
        self._v = 0


class Gauge:
    """Last-write-wins scalar (step counters, mass, queue depths)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str) -> None:
        self.name = name
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    def add(self, v: float) -> None:
        self._v += float(v)

    @property
    def value(self) -> float:
        return self._v

    def _reset(self) -> None:
        self._v = 0.0


class Histogram:
    """Fixed-bucket histogram (cumulative counts computed at export).

    ``observe`` costs one bisect and two adds; the bounds are fixed at
    creation."""

    __slots__ = ("name", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, bounds=DEFAULT_BUCKETS) -> None:
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram {name}: bounds must be strictly "
                             "increasing")
        self.counts = [0] * (len(self.bounds) + 1)  # +1 overflow bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def _reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0


class _Timed:
    __slots__ = ("_h", "_t0")

    def __init__(self, h: Histogram) -> None:
        self._h = h

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._h.observe(time.perf_counter() - self._t0)
        return False


# -- registry ----------------------------------------------------------------

class Registry:
    """Process-global instrument registry.

    Creating an instrument takes a lock; the instruments are lock-free.
    ``reset()`` zeroes values in place, so call sites may keep instruments
    across ``bf.init`` cycles."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._native_base: Dict[str, float] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._mu:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._mu:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str, bounds=DEFAULT_BUCKETS) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._mu:
                h = self._hists.setdefault(name, Histogram(name, bounds))
        return h

    def timed(self, name: str, bounds=DEFAULT_BUCKETS) -> _Timed:
        """Context manager observing the block's wall time in seconds."""
        return _Timed(self.histogram(name, bounds))

    def reset(self) -> None:
        """Zero every instrument in place and re-baseline the native
        counters (each ``bf.init`` starts a fresh job's telemetry epoch)."""
        with self._mu:
            for c in self._counters.values():
                c._reset()
            for g in self._gauges.values():
                g._reset()
            for h in self._hists.values():
                h._reset()
            self._native_base = _native_counters()

    def snapshot(self, include_native: bool = True) -> dict:
        """Point-in-time view of every instrument; with a control plane
        attached (and ``include_native``), the native transport counters
        merged in as deltas against the last ``reset()``."""
        from . import control_plane as _cp

        meta = {"schema": 1, "ts": time.time(), "rank": _process_index(),
                "inc": _cp.incarnation()}
        counters = {n: float(c._v) for n, c in self._counters.items()}
        gauges = {n: float(g._v) for n, g in self._gauges.items()}
        hists = {n: {"bounds": list(h.bounds), "counts": list(h.counts),
                     "sum": h.sum, "count": h.count}
                 for n, h in self._hists.items()}
        if include_native and _cp.active():
            base = self._native_base
            for name, v in _native_counters().items():
                # the fault injector's counters reset on every arm: raw
                if name.startswith("cp.fault."):
                    counters[name] = v
                else:
                    counters[name] = v - base.get(name, 0.0)
            for name, v in _server_stats_flat().items():
                # live aggregates are gauges, event counts counters
                if name.rsplit(".", 1)[-1] in _SERVER_GAUGE_FIELDS:
                    gauges[name] = v
                else:
                    counters[name] = v
        return {"meta": meta, "counters": counters, "gauges": gauges,
                "hists": hists}


_REGISTRY = Registry()


# module-level conveniences (the instrumented modules' entry points)

def registry() -> Registry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str, bounds=DEFAULT_BUCKETS) -> Histogram:
    return _REGISTRY.histogram(name, bounds)


def timed(name: str, bounds=DEFAULT_BUCKETS) -> _Timed:
    return _REGISTRY.timed(name, bounds)


def snapshot(include_native: bool = True) -> dict:
    return _REGISTRY.snapshot(include_native)


def reset_for_job() -> None:
    _REGISTRY.reset()


def _process_index() -> int:
    """This process's controller index (its control-plane rank while one
    is attached, else its rank): the ``<rank>`` of the KV keys and files
    it publishes."""
    from . import control_plane as _cp

    return _cp.process_index()


def _world_size() -> int:
    """The number of controllers: the control plane's world while one is
    attached, else the process group's size."""
    from . import control_plane as _cp
    from .state import _global_state

    if _cp.active():
        return _cp.world()
    st = _global_state()
    return st.size if st.initialized else 1


# -- native counter merge ----------------------------------------------------

_SERVER_GAUGE_FIELDS = {"live_connections", "mailbox_records",
                        "mailbox_bytes", "locks_held", "kv_entries",
                        "bytes_slots", "bytes_slot_bytes"}


def _native_counters() -> Dict[str, float]:
    """Flattened native client and fault-injector counters (cumulative;
    empty until the native library is loaded)."""
    from . import native as _native

    out: Dict[str, float] = {}
    stats = _native.client_stats()
    if not stats:
        return out
    for group in ("ops", "bytes_out", "bytes_in"):
        for op, v in stats.get(group, {}).items():
            out[f"cp.client.{group}.{op}"] = float(v)
    for k in ("redials", "redial_attempts", "stale_frames",
              "striped_transfers"):
        out[f"cp.client.{k}"] = float(stats[k])
    fault = _native.fault_stats()
    out["cp.fault.ops"] = float(fault["ops"])
    out["cp.fault.drops"] = float(fault["drops"])
    return out


def _server_stats_flat() -> Dict[str, float]:
    """Flattened control-plane server stats (only on the serving rank)."""
    from . import control_plane as _cp

    srv = _cp._server
    if srv is None:
        return {}
    out: Dict[str, float] = {}
    stats = srv.stats()
    for op, v in stats.get("ops", {}).items():
        out[f"cp.server.ops.{op}"] = float(v)
    for k, v in stats.items():
        if k != "ops":
            out[f"cp.server.{k}"] = float(v)
    return out


# -- packed snapshot wire format --------------------------------------------
#
#   magic "BFM1" | u16 schema | i32 rank | i64 inc | f64 ts
#   | u32 n_counters | (u16 len, name, f64 value)*
#   | u32 n_gauges   | (u16 len, name, f64 value)*
#   | u32 n_hists    | (u16 len, name, u16 nbounds, f64*nbounds bounds,
#                       u64*(nbounds+1) counts, f64 sum, u64 count)*

_MAGIC = b"BFM1"


def _pack_kv(out: bytearray, items: Dict[str, float]) -> None:
    out += struct.pack("<I", len(items))
    for name in sorted(items):
        nb = name.encode()
        out += struct.pack("<H", len(nb)) + nb
        out += struct.pack("<d", float(items[name]))


def pack_snapshot(snap: dict) -> bytes:
    meta = snap["meta"]
    out = bytearray()
    out += _MAGIC
    out += struct.pack("<Hiqd", meta.get("schema", 1),
                       int(meta.get("rank", 0)), int(meta.get("inc", 0)),
                       float(meta.get("ts", 0.0)))
    _pack_kv(out, snap.get("counters", {}))
    _pack_kv(out, snap.get("gauges", {}))
    hists = snap.get("hists", {})
    out += struct.pack("<I", len(hists))
    for name in sorted(hists):
        h = hists[name]
        nb = name.encode()
        bounds = h["bounds"]
        out += struct.pack("<H", len(nb)) + nb
        out += struct.pack("<H", len(bounds))
        out += struct.pack(f"<{len(bounds)}d", *bounds)
        out += struct.pack(f"<{len(bounds) + 1}Q", *h["counts"])
        out += struct.pack("<dQ", float(h["sum"]), int(h["count"]))
    return bytes(out)


def _unpack_kv(buf: bytes, off: int):
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    items: Dict[str, float] = {}
    for _ in range(n):
        (ln,) = struct.unpack_from("<H", buf, off)
        off += 2
        name = buf[off:off + ln].decode()
        off += ln
        (v,) = struct.unpack_from("<d", buf, off)
        off += 8
        items[name] = v
    return items, off


def unpack_snapshot(blob: bytes) -> dict:
    if len(blob) < 26 or blob[:4] != _MAGIC:
        raise ValueError("not a bluefog metrics snapshot (bad magic)")
    schema, rank, inc, ts = struct.unpack_from("<Hiqd", blob, 4)
    off = 4 + struct.calcsize("<Hiqd")
    counters, off = _unpack_kv(blob, off)
    gauges, off = _unpack_kv(blob, off)
    (nh,) = struct.unpack_from("<I", blob, off)
    off += 4
    hists: Dict[str, dict] = {}
    for _ in range(nh):
        (ln,) = struct.unpack_from("<H", blob, off)
        off += 2
        name = blob[off:off + ln].decode()
        off += ln
        (nb,) = struct.unpack_from("<H", blob, off)
        off += 2
        bounds = list(struct.unpack_from(f"<{nb}d", blob, off))
        off += 8 * nb
        counts = list(struct.unpack_from(f"<{nb + 1}Q", blob, off))
        off += 8 * (nb + 1)
        s, c = struct.unpack_from("<dQ", blob, off)
        off += 16
        hists[name] = {"bounds": bounds, "counts": counts, "sum": s,
                       "count": c}
    return {"meta": {"schema": schema, "rank": rank, "inc": inc, "ts": ts},
            "counters": counters, "gauges": gauges, "hists": hists}


# -- Prometheus text exposition ----------------------------------------------

# HELP text of the instruments the port records, in the JAX package's
# words; any other name gets its generic line.
_HELP_EXACT: Dict[str, str] = {
    "opt.step": "optimizer step counter of this rank",
    "opt.step_sec": "wall seconds per optimizer step",
}


def help_for(name: str) -> str:
    """HELP text for a metric, so every scraped sample is
    self-describing."""
    return _HELP_EXACT.get(name) or f"bluefog metric {name}"


def _prom_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_name(name: str) -> str:
    base = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)
    if base and base[0].isdigit():
        base = "_" + base
    return "bluefog_" + base


def _prom_value(v: float) -> str:
    if v == int(v) and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


def prometheus_text(snap: Optional[dict] = None) -> str:
    """Render a snapshot in the Prometheus text exposition format v0.0.4
    (counters, gauges, and classic ``_bucket``/``_sum``/``_count``
    histograms, labeled with the publishing rank)."""
    if snap is None:
        snap = _REGISTRY.snapshot()
    rank = snap["meta"].get("rank", 0)
    label = f'{{rank="{rank}"}}'
    lines: List[str] = []
    for name in sorted(snap.get("counters", {})):
        m = _prom_name(name)
        lines.append(f"# HELP {m} {_prom_help(help_for(name))}")
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m}{label} "
                     f"{_prom_value(snap['counters'][name])}")
    for name in sorted(snap.get("gauges", {})):
        m = _prom_name(name)
        lines.append(f"# HELP {m} {_prom_help(help_for(name))}")
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{label} {_prom_value(snap['gauges'][name])}")
    for name in sorted(snap.get("hists", {})):
        h = snap["hists"][name]
        m = _prom_name(name)
        lines.append(f"# HELP {m} {_prom_help(help_for(name))}")
        lines.append(f"# TYPE {m} histogram")
        cum = 0
        for bound, cnt in zip(h["bounds"], h["counts"]):
            cum += cnt
            lines.append(f'{m}_bucket{{rank="{rank}",le="{bound:g}"}} {cum}')
        cum += h["counts"][len(h["bounds"])]
        lines.append(f'{m}_bucket{{rank="{rank}",le="+Inf"}} {cum}')
        lines.append(f"{m}_sum{label} {_prom_value(h['sum'])}")
        lines.append(f"{m}_count{label} {h['count']}")
    return "\n".join(lines) + "\n"


# -- publication -------------------------------------------------------------

def publish_interval() -> float:
    """Seconds between publications; 0 = publication disabled.
    ``BFT_METRICS_PROM`` alone implies a 10 s cadence."""
    interval = knob_env("BFT_METRICS_INTERVAL")
    if interval is not None:
        return max(0.0, interval)
    return 10.0 if knob_env("BFT_METRICS_PROM") else 0.0


def publication_enabled() -> bool:
    return publish_interval() > 0


_pub_mu = threading.Lock()
_last_publish = 0.0

# control-plane KV keys of the published snapshots
_WORLD_KEY = "bf.metrics.world"


def _metrics_key(rank: int) -> str:
    return f"bf.metrics.{rank}"


def prom_path(rank: int, world: int) -> Optional[str]:
    """The Prometheus file of ``rank``: ``BFT_METRICS_PROM`` itself in a
    world of one, else ``<root>.<rank><ext>`` of it (``scrape.prom`` ->
    ``scrape.3.prom``), since the ranks of a host would replace each
    other's file."""
    path = knob_env("BFT_METRICS_PROM")
    if not path or world <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.{rank}{ext}"


def _write_prom_file(snap: dict) -> None:
    path = prom_path(snap["meta"]["rank"], _world_size())
    if not path:
        return
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(prometheus_text(snap))
        os.replace(tmp, path)  # atomic: scrapers never see a torn file
    except OSError as exc:
        logger.warning("metrics: prometheus dump to %s failed (%s)",
                       path, exc)


def publish_now(cl=None) -> dict:
    """Publish one snapshot unconditionally (Prometheus file and, through
    ``cl`` or the attached control plane, the KV); returns it."""
    return _publish(cl, force=True)


def maybe_publish(cl=None) -> Optional[dict]:
    """Interval-gated publish (the cadence thread's tick)."""
    return _publish(cl, force=False)


def _publish(cl, force: bool) -> Optional[dict]:
    global _last_publish
    interval = publish_interval()
    if not force and interval <= 0:
        return None
    now = time.monotonic()
    with _pub_mu:
        if not force and now - _last_publish < interval:
            return None
        _last_publish = now
    snap = _REGISTRY.snapshot()
    _emit_timeline_counters(snap)
    _write_prom_file(snap)
    from . import control_plane as _cp

    if cl is None and _cp.active():
        cl = _cp.client()
    if cl is not None:
        try:
            cl.put_bytes(_metrics_key(snap["meta"]["rank"]),
                         pack_snapshot(snap))
            cl.put(_WORLD_KEY, _world_size())
        except (OSError, RuntimeError) as exc:  # telemetry must not raise
            logger.debug("metrics publish failed (%s)", exc)
    return snap


def _emit_timeline_counters(snap: dict) -> None:
    """Mirror the gauges onto chrome counter tracks, so traces and metrics
    share one vocabulary."""
    from .timeline import _timeline

    tl = _timeline()
    if tl is None:
        return
    for name, v in snap.get("gauges", {}).items():
        tl.counter(name, int(v))


class _Publisher:
    """Cadence thread publishing on ``BFT_METRICS_INTERVAL``, for jobs
    without a heartbeat monitor (one controller): with several, the
    heartbeat's tick carries :func:`maybe_publish` instead."""

    def __init__(self) -> None:
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="bft-metrics-publisher", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(max(0.2, publish_interval() / 2.0)):
            try:
                maybe_publish()
                # the time-series plane samples on the same cadence
                # (heartbeat jobs ride the monitor's tick instead)
                from . import timeseries as _ts

                _ts.maybe_sample()
            except Exception as exc:  # noqa: BLE001 — observability thread
                logger.debug("metrics publisher tick failed (%s)", exc)


_publisher: Optional[_Publisher] = None


def start_publisher_if_needed(has_heartbeat: bool) -> None:
    """Called by ``bf.init``: start the cadence thread only when
    publication is enabled AND no heartbeat monitor exists to ride on."""
    global _publisher
    if not publication_enabled() or has_heartbeat:
        return
    if _publisher is None:
        _publisher = _Publisher()
    _publisher.start()


def stop_publisher() -> None:
    global _publisher
    if _publisher is not None:
        _publisher.stop()
        _publisher = None


# -- health ------------------------------------------------------------------

def _straggler_threshold() -> int:
    return max(1, int(knob_env("BFT_STRAGGLER_STEPS")))


def health_from_snapshots(snaps: Dict[int, dict], world: int,
                          interval: Optional[float] = None,
                          now: Optional[float] = None) -> dict:
    """Merge per-rank snapshots into the health view.

    * per-rank staleness (wall seconds since that rank's snapshot) and an
      ``alive`` verdict (stale past 3 publish intervals, at least 15 s);
    * stragglers: ranks whose ``opt.step`` gauge trails the maximum by at
      least ``BFT_STRAGGLER_STEPS`` (default 3), and stale ranks;
    * push-sum mass conservation: the live ranks' ``pushsum.mass`` against
      the mass they minted, within an ulp-scaled tolerance.
    """
    if interval is None:
        interval = publish_interval() or 10.0
    if now is None:
        now = time.time()
    stale_after = max(3.0 * interval, 15.0)
    ranks: Dict[int, dict] = {}
    steps: Dict[int, float] = {}
    epoch = 0
    repl_lag = under_repl = 0.0
    have_repl = False
    for pid, s in sorted(snaps.items()):
        staleness = max(0.0, now - s["meta"]["ts"])
        step = s["gauges"].get("opt.step")
        ranks[pid] = {
            "staleness_sec": staleness,
            "alive": staleness < stale_after,
            "incarnation": s["meta"].get("inc", 0),
            "step": None if step is None else int(step),
            "shard_drops": int(s["counters"].get(
                "win.shard_stale_drops", 0)),
        }
        if step is not None:
            steps[pid] = step
        epoch = max(epoch, int(s["gauges"].get("membership.epoch", 0)))
        if "cp.repl_lag" in s["gauges"] or \
                "cp.under_replicated" in s["gauges"]:
            have_repl = True
            repl_lag = max(repl_lag, s["gauges"].get("cp.repl_lag", 0.0))
            under_repl = max(under_repl,
                             s["gauges"].get("cp.under_replicated", 0.0))
    missing = sorted(set(range(world)) - set(snaps))
    stragglers: List[int] = []
    if steps:
        mx = max(steps.values())
        thr = _straggler_threshold()
        stragglers = sorted(p for p, v in steps.items() if mx - v >= thr)
        # a rank too stale to publish is behind by definition
        stragglers = sorted(set(stragglers) | {
            p for p, r in ranks.items()
            if not r["alive"] and p in steps})
    live = {p: s for p, s in snaps.items() if ranks[p]["alive"]}
    mass = None
    if any("pushsum.mass" in s["gauges"] for s in live.values()):
        total = sum(s["gauges"].get("pushsum.mass", 0.0)
                    for s in live.values())
        minted = sum(s["gauges"].get("pushsum.minted", 0.0)
                     for s in live.values())
        drift = total - minted
        tol = max(1e-12,
                  float(np.spacing(max(1.0, abs(minted)))) * max(1, world))
        mass = {"total": total, "minted": minted, "drift": drift,
                "tolerance": tol, "conserved": abs(drift) <= tol}
    return {"world": world, "ranks": ranks, "missing": missing,
            "stragglers": stragglers, "mass": mass,
            "membership_epoch": epoch,
            "repl": ({"lag": repl_lag, "under_replicated": int(under_repl)}
                     if have_repl else None)}


def read_cluster_health(cl, world: Optional[int] = None) -> dict:
    """The health view from a raw control-plane client: usable from
    OUTSIDE the job as well as from within. ``world`` defaults to the
    published ``bf.metrics.world``."""
    if world is None:
        world = int(cl.get(_WORLD_KEY)) or 1
    snaps: Dict[int, dict] = {}
    for r in range(world):
        try:
            blob = cl.get_bytes(_metrics_key(r))
        except OSError:
            continue
        if not blob:
            continue
        try:
            snaps[r] = unpack_snapshot(blob)
        except (ValueError, struct.error) as exc:
            logger.warning("metrics: snapshot for rank %d unreadable (%s)",
                           r, exc)
    return health_from_snapshots(snaps, world)


def cluster_health() -> dict:
    """The merged cluster health view (:func:`health_from_snapshots`).

    With a control plane attached, every other rank's published snapshot
    is read from the KV, and this process's own from its live registry
    (its KV copy can be a publish interval old); without one, the view is
    this process's registry alone. A rank that never published shows up
    in ``missing``.
    """
    from . import control_plane as _cp

    world = _world_size()
    me = _process_index()
    snaps = {me: _REGISTRY.snapshot()}
    if _cp.active():
        cl = _cp.client()
        for r in set(range(world)) - {me}:
            try:
                blob = cl.get_bytes(_metrics_key(r))
                if blob:
                    snaps[r] = unpack_snapshot(blob)
            except (OSError, ValueError, struct.error):
                pass
    return health_from_snapshots(snaps, world)


def format_health(health: dict) -> str:
    """Human-readable rendering of :func:`health_from_snapshots`."""
    lines = [f"cluster health — world {health['world']}, membership epoch "
             f"{health['membership_epoch']}"]
    for pid in sorted(health["ranks"]):
        r = health["ranks"][pid]
        step = "-" if r["step"] is None else str(r["step"])
        flags = []
        if not r["alive"]:
            flags.append("STALE")
        if pid in health["stragglers"]:
            flags.append("STRAGGLER")
        drops = r.get("shard_drops", 0)
        lines.append(
            f"  rank {pid}: step {step}, inc {r['incarnation']}, "
            f"published {r['staleness_sec']:.1f}s ago"
            + (f", shard_drops {drops}" if drops else "")
            + (f"  [{' '.join(flags)}]" if flags else ""))
    for pid in health["missing"]:
        lines.append(f"  rank {pid}: no snapshot published")
    m = health["mass"]
    if m is not None:
        verdict = "conserved" if m["conserved"] else "DRIFTING"
        lines.append(
            f"  push-sum mass: total {m['total']:.12g} vs minted "
            f"{m['minted']:.12g} (drift {m['drift']:.3g}) — {verdict}")
    repl = health.get("repl")
    if repl is not None:
        state = (f"{repl['under_replicated']} shard(s) UNDER-REPLICATED"
                 if repl["under_replicated"] else "replicating")
        lines.append(f"  control-plane replication: max WAL lag "
                     f"{repl['lag']:.0f} — {state}")
    if health["stragglers"]:
        lines.append(f"  stragglers: {health['stragglers']}")
    return "\n".join(lines)
