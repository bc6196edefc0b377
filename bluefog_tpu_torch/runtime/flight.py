"""Always-on flight recorder: a black box for postmortem dumps.

Counterpart of ``bluefog_tpu/runtime/flight.py``. A fixed-capacity ring of
spans, instants, counters and flow events in preallocated numpy columns
(slotted stores, no per-event object kept), dumped with a metrics
snapshot when something goes wrong:

  * a fatal exception escaping an optimizer step,
  * a failed transfer surfacing in ``synchronize``,
  * an uncaught exception unwinding the process (the ``sys.excepthook``
    chain ``bf.init`` installs and ``bf.shutdown`` restores),
  * an explicit ``bf.flight_dump()``.

A dump is ``bf_flight_<rank>.json`` under ``BFT_FLIGHT_DIR`` (default: the
working directory), in the JAX package's document format: its readers
(``scripts/step_attribution.py``, :func:`analyze_dump`,
:func:`merge_dumps`) read the port's dumps unchanged, and
:func:`pack_dump`/:func:`unpack_dump` are byte-compatible with its packed
form. Every dump carries a wall-clock anchor, so per-rank dumps merge onto
one axis.

Recording is always on (``BFT_FLIGHT_DISABLE=1`` opts out); only dumping
does I/O. A torn or lost record under a race between threads is an
acceptable telemetry error, as in the metrics registry. The JAX package's
remote dump trigger and its native transport ring need a control plane,
which the port does not have yet.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
import traceback
import zlib
from typing import Dict, List, Optional

import numpy as np

from .config import knob_env
from .logging import logger

# -- event kinds -------------------------------------------------------------

SPAN_B = 1    # span begin              (a = arg, b = aux)
SPAN_E = 2    # span end                (a = arg, b = aux)
INSTANT = 3   # point event             (a = arg, b = aux)
COUNTER = 4   # counter sample          (a = value)
FLOW_S = 5    # flow start (deposit)    (a = bytes, b = flow id)
FLOW_F = 6    # flow finish (drain)     (a = bytes, b = flow id)

_KIND_NAMES = {SPAN_B: "B", SPAN_E: "E", INSTANT: "i", COUNTER: "C",
               FLOW_S: "s", FLOW_F: "f"}

_PACK_MAGIC = b"BFF1"


class FlightRecorder:
    """Fixed-capacity ring of recent events.

    The hot path (:meth:`rec`) is five slotted stores into preallocated
    numpy columns plus one ``perf_counter_ns``: no lock, no Python object
    kept per event. Name interning (:meth:`intern`) allocates only the
    first time a name is seen.
    """

    def __init__(self, capacity: Optional[int] = None) -> None:
        if capacity is None:
            capacity = int(knob_env("BFT_FLIGHT_CAPACITY"))
        cap = 1
        while cap < max(256, capacity):
            cap <<= 1
        self._mask = cap - 1
        self._kind = np.zeros(cap, np.int64)
        self._name = np.zeros(cap, np.int64)
        self._t = np.zeros(cap, np.int64)      # perf_counter_ns
        self._a = np.zeros(cap, np.float64)
        self._b = np.zeros(cap, np.int64)
        self._n = 0
        self._names: List[str] = []
        self._ids: Dict[str, int] = {}
        self._mu = threading.Lock()  # interning only — never the hot path
        # Clock-sync anchor: wall-clock microseconds captured against the
        # perf_counter origin the ring records, so dumps from different
        # processes land on one wall-clock axis.
        self._anchor_perf_ns = time.perf_counter_ns()
        self._anchor_wall_us = time.time_ns() // 1000

    @property
    def capacity(self) -> int:
        return self._mask + 1

    # -- producer side (any thread; a rare lost record is acceptable) ------

    def intern(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            with self._mu:
                i = self._ids.get(name)
                if i is None:
                    i = len(self._names)
                    self._names.append(name)
                    self._ids[name] = i
        return i

    def rec(self, kind: int, name_id: int, a: float = 0.0,
            b: int = 0) -> None:
        i = self._n & self._mask
        self._t[i] = time.perf_counter_ns()
        self._kind[i] = kind
        self._name[i] = name_id
        self._a[i] = a
        self._b[i] = b
        self._n += 1

    # conveniences (intern per call — fine off the hot path)

    def begin(self, name: str, a: float = 0.0, b: int = 0) -> None:
        self.rec(SPAN_B, self.intern(name), a, b)

    def end(self, name: str, a: float = 0.0, b: int = 0) -> None:
        self.rec(SPAN_E, self.intern(name), a, b)

    def instant(self, name: str, a: float = 0.0, b: int = 0) -> None:
        self.rec(INSTANT, self.intern(name), a, b)

    def counter(self, name: str, value: float) -> None:
        self.rec(COUNTER, self.intern(name), value)

    @contextlib.contextmanager
    def span(self, name: str, a: float = 0.0, b: int = 0):
        nid = self.intern(name)
        self.rec(SPAN_B, nid, a, b)
        try:
            yield
        finally:
            self.rec(SPAN_E, nid, a, b)

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Decode the ring oldest to newest into plain lists."""
        n = self._n
        cap = self._mask + 1
        count = min(n, cap)
        idx = (n - count + np.arange(count)) & self._mask
        wall = self._anchor_wall_us + \
            (self._t[idx] - self._anchor_perf_ns) / 1e3
        return {
            "schema": 1,
            "anchor": {"wall_us": self._anchor_wall_us},
            "recorded": n,
            "dropped": max(0, n - cap),
            "names": list(self._names),
            "events": {
                "kind": self._kind[idx].tolist(),
                "name": self._name[idx].tolist(),
                "t_wall_us": wall.tolist(),
                "a": self._a[idx].tolist(),
                "b": self._b[idx].tolist(),
            },
        }


class _NullRecorder:
    """Recording disabled (``BFT_FLIGHT_DISABLE=1``): every entry point is
    a no-op, so call sites never branch."""

    capacity = 0

    def intern(self, name: str) -> int:
        return 0

    def rec(self, *a, **k) -> None:
        pass

    begin = end = instant = counter = rec

    @contextlib.contextmanager
    def span(self, *a, **k):
        yield

    def snapshot(self) -> dict:
        return {"schema": 1, "anchor": {"wall_us": time.time_ns() // 1000},
                "recorded": 0, "dropped": 0, "names": [],
                "events": {"kind": [], "name": [], "t_wall_us": [], "a": [],
                           "b": []}}


def _new_recorder():
    return _NullRecorder() if knob_env("BFT_FLIGHT_DISABLE") \
        else FlightRecorder()


_rec_mu = threading.Lock()
_recorder = None


def recorder():
    """The process-global recorder (created on first use; always on unless
    ``BFT_FLIGHT_DISABLE=1``)."""
    global _recorder
    r = _recorder
    if r is None:
        with _rec_mu:
            if _recorder is None:
                _recorder = _new_recorder()
            r = _recorder
    return r


def reset_for_job() -> None:
    """Fresh ring and clock anchor for a new ``bf.init`` (a dump belongs to
    the job that crashed, not its predecessor); re-reads the disable and
    capacity knobs."""
    global _recorder, _last_dump
    with _rec_mu:
        _recorder = _new_recorder()
    _last_dump = 0.0


# -- dumping -----------------------------------------------------------------

_last_dump = 0.0
_dump_mu = threading.Lock()


def _identity():
    from .state import _global_state

    st = _global_state()
    if st.initialized:
        return st.rank, st.size
    return 0, 1


def build_dump(reason: str, exc: Optional[BaseException] = None) -> dict:
    """Assemble the dump document: identity, the ring's tail and a metrics
    snapshot. Never raises."""
    rank, world = _identity()
    doc = {
        "schema": 1,
        "meta": {
            "reason": reason,
            "rank": rank,
            "world": world,
            "inc": 0,
            "pid": os.getpid(),
            "ts": time.time(),
            "exception": None if exc is None else "".join(
                traceback.format_exception_only(type(exc), exc)).strip(),
        },
    }
    doc.update(recorder().snapshot())
    try:
        from . import metrics as _metrics

        doc["metrics"] = _metrics.snapshot()
    except Exception as e:  # noqa: BLE001 — a dump must always produce
        doc["metrics"] = {}
        logger.debug("flight: metrics snapshot failed (%s)", e)
    return doc


def pack_dump(doc: dict) -> bytes:
    """Packed form of a dump: magic + zlib'd JSON, the JAX package's."""
    return _PACK_MAGIC + zlib.compress(json.dumps(doc).encode(), level=6)


def unpack_dump(blob: bytes) -> dict:
    if len(blob) < 4 or blob[:4] != _PACK_MAGIC:
        raise ValueError("not a packed flight dump (bad magic)")
    return json.loads(zlib.decompress(blob[4:]).decode())


def dump(reason: str = "explicit", exc: Optional[BaseException] = None,
         path: Optional[str] = None, force: bool = True) -> Optional[str]:
    """Write the flight dump; returns its path, or None when rate-limited
    or the write failed. Never raises.

    ``force=False`` applies the automatic-trigger rate limit
    (``BFT_FLIGHT_MIN_INTERVAL``), so a failure storm cannot spam dumps;
    explicit dumps bypass it.
    """
    global _last_dump
    now = time.monotonic()
    with _dump_mu:
        if not force:
            min_gap = float(knob_env("BFT_FLIGHT_MIN_INTERVAL"))
            if _last_dump and now - _last_dump < min_gap:
                return None
        _last_dump = now
    doc = build_dump(reason, exc)
    if path is None:
        path = os.path.join(knob_env("BFT_FLIGHT_DIR") or ".",
                            f"bf_flight_{doc['meta']['rank']}.json")
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except OSError as e:
        logger.error("flight: local dump to %s failed (%s)", path, e)
        return None
    logger.error("flight recorder dump (%s) -> %s", reason, path)
    return path


def fatal(where: str, exc: BaseException) -> Optional[str]:
    """Record a fatal instant and dump (rate-limited). The instant lands in
    the ring before the snapshot, so the dump holds the failure marker."""
    recorder().instant(f"fatal.{where}")
    return dump(reason=f"{where}: {type(exc).__name__}", exc=exc,
                force=False)


# -- abnormal-exit hook ------------------------------------------------------

_hook_installed = False
_prev_hook = None


def _hook(exc_type, exc, tb):
    try:
        fatal("uncaught", exc if exc is not None else exc_type())
    except Exception:  # noqa: BLE001 — never mask the real traceback
        pass
    _prev_hook(exc_type, exc, tb)


def install_excepthook() -> None:
    """Chain ``sys.excepthook`` so an uncaught exception unwinding the
    process leaves a dump behind. Idempotent."""
    global _hook_installed, _prev_hook
    if _hook_installed:
        return
    _hook_installed = True
    _prev_hook = sys.excepthook
    sys.excepthook = _hook


def uninstall_excepthook() -> None:
    """Put back the hook :func:`install_excepthook` chained (``bf.shutdown``).
    When another hook has been installed over ours since, ours stays in
    its chain, and installed."""
    global _hook_installed, _prev_hook
    if _hook_installed and sys.excepthook is _hook:
        sys.excepthook = _prev_hook
        _hook_installed = False
        _prev_hook = None


# -- chrome-tracing conversion + cross-rank merge ----------------------------

# the JAX package's native transport ring kinds, for reading its dumps
_NATIVE_KINDS = {1: "redial_attempt", 2: "redial", 3: "stale_frame",
                 4: "stripe", 5: "striped_xfer", 6: "shard_failover"}


def chrome_events(doc: dict) -> list:
    """Convert one dump to chrome-tracing events on the wall-clock axis (a
    leading ``bf.clock_sync_us`` counter keeps the result merge-compatible
    with timeline files)."""
    pid = doc.get("meta", {}).get("rank", 0)
    names = doc.get("names", [])
    ev = doc.get("events", {})
    out: list = []
    ts0 = None
    for kind, nid, ts, a, b in zip(ev.get("kind", []), ev.get("name", []),
                                   ev.get("t_wall_us", []), ev.get("a", []),
                                   ev.get("b", [])):
        if ts0 is None:
            ts0 = ts
            out.append({"name": "bf.clock_sync_us", "cat": "bf", "ph": "C",
                        "ts": ts, "pid": pid, "tid": 0,
                        "args": {"value": ts}})
        name = names[nid] if 0 <= nid < len(names) else f"?{nid}"
        ph = _KIND_NAMES.get(kind)
        if ph is None:
            continue
        e = {"name": name, "cat": "bf.flight", "ph": ph, "ts": ts,
             "pid": pid, "tid": 0}
        if ph == "B" or ph == "E":
            e["args"] = {"a": a, "b": b}
        elif ph == "i":
            e["s"] = "t"
            e["args"] = {"a": a, "b": b}
        elif ph == "C":
            e["args"] = {"value": a}
        else:  # flow s/f — id binds deposit to drain across ranks
            e["cat"] = "bf.flow"
            e["id"] = int(b)
            e["args"] = {"bytes": a}
            if ph == "f":
                e["bp"] = "e"
        out.append(e)
    for t_us, kind, a, b in doc.get("native", []):
        out.append({"name": f"native.{_NATIVE_KINDS.get(kind, kind)}",
                    "cat": "bf.native", "ph": "i", "s": "t", "ts": t_us,
                    "pid": pid, "tid": 999, "args": {"a": a, "b": b}})
    return out


def merge_dumps(docs: List[dict]) -> list:
    """Merge per-rank dumps into one chrome trace (earliest event at
    ts=0)."""
    events: list = []
    pids = set()
    for doc in docs:
        events.extend(chrome_events(doc))
        pids.add(doc.get("meta", {}).get("rank", 0))
    if events:
        base = min(e["ts"] for e in events)
        for e in events:
            e["ts"] = e["ts"] - base
    events.sort(key=lambda e: e.get("ts", 0.0))
    for pid in sorted(pids):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"bluefog rank {pid}"}})
    return events


# -- step-time attribution ---------------------------------------------------

# span name -> phase bucket (the JAX package's vocabulary; the port's
# optimizers record only ``opt.step``, so its steps land in ``other``).
_PHASE_OF = {
    "opt.local": "local",
    "opt.pack": "pack",
    "opt.unpack": "unpack",
    "win.wire": "wire",
    "win.publish": "wire",
    "win.drain": "drain",
    "win.fold": "fold",
    "win.compiled": "compiled",
}
_PHASES = ("local", "pack", "wire", "drain", "fold", "unpack", "compiled")


def _overlap(iv_a, iv_b) -> float:
    """Total seconds of intervals in iv_a covered by intervals in iv_b."""
    total = 0.0
    for a0, a1 in iv_a:
        for b0, b1 in iv_b:
            lo, hi = max(a0, b0), min(a1, b1)
            if hi > lo:
                total += hi - lo
    return total


def _spans_in(doc_events, names, t0, t1):
    """Matched (begin, end) wall-us intervals for each span name, clipped
    to [t0, t1]; unmatched begins are ignored."""
    out: Dict[str, list] = {n: [] for n in names}
    open_at: Dict[str, list] = {}
    for kind, name, ts in doc_events:
        if name not in out:
            continue
        if kind == SPAN_B:
            open_at.setdefault(name, []).append(ts)
        elif kind == SPAN_E and open_at.get(name):
            b = open_at[name].pop()
            lo, hi = max(b, t0), min(ts, t1)
            if hi > lo:
                out[name].append((lo, hi))
    return out


def analyze_dump(doc: dict) -> Optional[dict]:
    """Per-step attribution over one dump: the last complete ``opt.step``
    span's phase breakdown plus per-edge deposit totals. None when the ring
    holds no complete step."""
    names = doc.get("names", [])
    ev = doc.get("events", {})
    rows = [(k, names[n] if 0 <= n < len(names) else "?", t, a, b)
            for k, n, t, a, b in zip(ev.get("kind", []), ev.get("name", []),
                                     ev.get("t_wall_us", []),
                                     ev.get("a", []), ev.get("b", []))]
    step_b = step_e = None
    step_no = None
    for k, name, t, a, b in reversed(rows):
        if name != "opt.step":
            continue
        if k == SPAN_E and step_e is None:
            step_e, step_no = t, b
        elif k == SPAN_B and step_e is not None and t < step_e:
            step_b = t
            break
    if step_b is None or step_e is None:
        return None
    t0, t1 = step_b, step_e
    step_sec = (t1 - t0) / 1e6
    triples = [(k, name, t) for k, name, t, _, _ in rows]
    spans = _spans_in(triples, set(_PHASE_OF) | {"opt.gossip"}, t0, t1)
    phases = {p: 0.0 for p in _PHASES}
    for name, ivs in spans.items():
        p = _PHASE_OF.get(name)
        if p:
            phases[p] += sum(hi - lo for lo, hi in ivs) / 1e6
    # fold spans nest inside the drain sweep and the get path's pull leg:
    # carve the overlap out so buckets stay disjoint
    phases["drain"] -= _overlap(spans["win.drain"], spans["win.fold"]) / 1e6
    phases["wire"] -= _overlap(spans["win.wire"], spans["win.fold"]) / 1e6
    gossip_sec = sum(hi - lo for lo, hi in spans["opt.gossip"]) / 1e6
    attributed = sum(phases.values())
    other = max(0.0, step_sec - attributed)
    edges: Dict[str, dict] = {}
    drains: Dict[str, dict] = {}
    for k, name, t, a, b in rows:
        if not t0 <= t <= t1:
            continue
        if k == FLOW_S and name.startswith("edge."):
            _, src, dst = name.split(".")
            e = edges.setdefault(f"{src}->{dst}",
                                 {"bytes": 0.0, "deposits": 0})
            e["bytes"] += a
            e["deposits"] += 1
        elif k == FLOW_F and name.startswith("drain."):
            d = drains.setdefault(name.split(".", 1)[1],
                                  {"bytes": 0.0, "deposits": 0})
            d["bytes"] += a
            d["deposits"] += 1
    # apportion the wire phase over edges by byte share
    total_edge_bytes = sum(e["bytes"] for e in edges.values())
    for e in edges.values():
        share = e["bytes"] / total_edge_bytes if total_edge_bytes else 0.0
        e["wire_sec_est"] = phases["wire"] * share
    return {
        "step": int(step_no or 0),
        "step_sec": step_sec,
        "gossip_sec": gossip_sec,
        "phases": phases,
        "other_sec": other,
        "coverage": attributed / step_sec if step_sec else 0.0,
        "edges": edges,
        "drains": drains,
    }


def step_report() -> Optional[dict]:
    """``bf.step_report()``: attribution of the most recent complete
    optimizer step from the live ring (no dump file needed). None until a
    step completed."""
    return analyze_dump(recorder().snapshot())


def format_report(rep: dict) -> str:
    lines = [f"step {rep['step']}: {rep['step_sec'] * 1e3:.2f} ms "
             f"(gossip {rep['gossip_sec'] * 1e3:.2f} ms, attribution "
             f"coverage {rep['coverage'] * 100:.0f}%)"]
    for p in _PHASES:
        v = rep["phases"].get(p, 0.0)
        lines.append(f"  {p:<8} {v * 1e3:9.3f} ms")
    lines.append(f"  {'other':<7} {rep['other_sec'] * 1e3:9.3f} ms")
    if rep["edges"]:
        lines.append("  edges (deposits sent):")
        for edge in sorted(rep["edges"],
                           key=lambda e: -rep["edges"][e]["bytes"]):
            e = rep["edges"][edge]
            lines.append(
                f"    {edge:<8} {e['deposits']:3d} deposits, "
                f"{e['bytes'] / 1e6:8.2f} MB, "
                f"~{e['wire_sec_est'] * 1e3:.3f} ms wire")
    if rep["drains"]:
        lines.append("  drains (deposits folded, by origin):")
        for origin in sorted(rep["drains"]):
            d = rep["drains"][origin]
            lines.append(f"    origin {origin}: {d['deposits']} deposits, "
                         f"{d['bytes'] / 1e6:.2f} MB")
    return "\n".join(lines)
