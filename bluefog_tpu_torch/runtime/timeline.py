"""Chrome-tracing timeline.

Counterpart of ``bluefog_tpu/runtime/timeline.py``: named activities
streamed through a ``queue.SimpleQueue`` to a writer thread producing
chrome-tracing JSON (chrome://tracing or Perfetto). ``BFT_TIMELINE=<prefix>``
enables it at ``bf.init``, one file ``<prefix><rank>.json`` per process (the
port runs one process per rank), or :func:`start_timeline` at run time.
Every file starts with the ``bf.clock_sync_us`` counter, the wall clock at
ts=0, so ``scripts/merge_timelines.py`` lays the ranks' files on one axis.
``Timeline(use_native=True)`` writes through the native library's writer
(``bf_timeline_*`` of ``csrc/bf_runtime.cc``, built at first use) instead
of the Python writer thread; the file is the same chrome JSON.

Events are stamped on the clock ``torch.profiler`` stamps its host events
with, the wall clock (``time.time_ns()``), counted from the clock anchor,
so a timeline file, a profiler trace and the card's activity in it lie on
one axis.

:class:`timeline_context` is the one span helper of the port: a single
``with`` records a named span in every reader that is on. The timeline's
span while the timeline is on; ``torch.profiler.record_function(
"<name>.<activity>")`` only while a profiler runs (the counterpart of the
JAX package's ``jax.profiler.TraceAnnotation``: the CUDA kernels the span
launches land inside its named range); and, given ``flight=``, the flight
recorder's span of that name, which ``bf.step_report()`` reads. With the
profiler and the timeline off a span costs a flag check and the flight
ring's two stores. A span times the host's issue of the work, as the JAX
package's spans time a jitted dispatch.

Flow events (:func:`timeline_flow_start`/:func:`timeline_flow_finish`,
``ph: "s"``/``"f"``, category ``bf.flow``) bind an event in one process's
trace to one in another's by id: the hosted window plane opens one at each
deposit (``WIN_DEPOSIT``, id ``origin << 32 | counter``, the deposit's tag
sequence) and closes it where the owner's drain folds that deposit, so the
merged per-rank files draw an arrow from the ``win_put`` to the
``win_update``. Under ``torch.profiler`` each flow event is also an empty
``record_function`` range named ``<name>.s.<id>`` / ``<name>.f.<id>``.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Optional

import torch

from . import flight as _flight
from . import metrics as _metrics
from .logging import logger

# Seconds the Python writer lets events gather before it writes them
_DRAIN_S = 0.02

# Counter-event name anchoring each per-process trace to the wall clock;
# scripts/merge_timelines.py keys on it to align files before merging.
CLOCK_SYNC_COUNTER = "bf.clock_sync_us"


class Timeline:
    """Streaming chrome-tracing writer with named activities per (name, lane)."""

    _SENTINEL = object()

    def __init__(self, prefix: str, process_index: Optional[int] = None,
                 use_native: bool = False) -> None:
        if process_index is None:
            from .state import _global_state

            st = _global_state()
            process_index = st.rank if st.initialized else 0
        pid = process_index
        self.path = f"{prefix}{pid}.json"
        # the profiler's clock, at a whole microsecond: ts = 0 is the
        # anchor's value exactly
        self._t0 = time.time_ns() // 1000 * 1000
        self._pid = pid
        self._closed = False
        self._failed = False  # writer died: stop producing so the queue can't grow
        self._native = None
        # serializes native emission against close(): bf_timeline_close
        # frees the C++ writer under any producer still holding the handle
        self._native_mu = threading.Lock()
        if use_native:
            from . import native as _native

            self._native_lib = _native.load()
            self._native = self._native_lib.bf_timeline_open(
                self.path.encode(), pid)
            if not self._native:
                raise OSError(f"native timeline writer failed to open "
                              f"{self.path}")
        else:
            self._q: "queue.SimpleQueue" = queue.SimpleQueue()
            self._writer = threading.Thread(
                target=self._writer_loop, name="bft-timeline-writer",
                daemon=True)
            self._writer.start()
        # Clock-sync anchor: the first event of every trace is a counter
        # carrying the wall-clock microseconds at ts=0.
        self._put({"name": CLOCK_SYNC_COUNTER, "cat": "bf", "ph": "C",
                   "ts": 0, "pid": pid, "tid": 0,
                   "args": {"value": self._t0 // 1000}})

    # -- producer side (any thread) ---------------------------------------

    def _now_us(self) -> float:
        return (time.time_ns() - self._t0) / 1e3

    def _put(self, ev: dict) -> None:
        if self._failed or self._closed:
            return
        if self._native is None:
            self._q.put(ev)
            return
        with self._native_mu:
            if self._native is None:
                return
            if ev["ph"] in ("C", "s", "f"):
                self._native_lib.bf_timeline_event2(
                    self._native, ev["name"].encode(), ev["cat"].encode(),
                    ev["ph"].encode(), int(ev["ts"]), ev["tid"],
                    int(ev["args"]["value"]))
            else:
                self._native_lib.bf_timeline_event(
                    self._native, ev.get("name", "").encode(),
                    ev["cat"].encode(), ev["ph"].encode(), int(ev["ts"]),
                    ev["tid"])

    def activity_start(self, tensor_name: str, activity: str,
                       tid: int = 0, args: Optional[dict] = None) -> None:
        ev = {"name": activity, "cat": tensor_name, "ph": "B",
              "ts": self._now_us(), "pid": self._pid, "tid": tid}
        if args:
            ev["args"] = args    # the Python writer's only: native drops it
        self._put(ev)

    def activity_end(self, tensor_name: str, tid: int = 0) -> None:
        self._put({"ph": "E", "ts": self._now_us(), "pid": self._pid,
                   "tid": tid, "cat": tensor_name})

    def instant(self, tensor_name: str, activity: str, tid: int = 0) -> None:
        """Point event (``ph: "i"``): stall warnings, membership
        transitions."""
        self._put({"name": activity, "cat": tensor_name, "ph": "i", "s": "t",
                   "ts": self._now_us(), "pid": self._pid, "tid": tid})

    def counter(self, name: str, value: int, tid: int = 0) -> None:
        """Chrome counter-track sample (``ph: "C"``): the metrics gauges
        and the clock-sync anchor ride these."""
        self._put({"name": name, "cat": "bf", "ph": "C", "ts": self._now_us(),
                   "pid": self._pid, "tid": tid,
                   "args": {"value": int(value)}})

    def _flow(self, phase: str, name: str, flow_id: int, tid: int) -> None:
        ev = {"name": name, "cat": "bf.flow", "ph": phase,
              "id": int(flow_id), "ts": self._now_us(), "pid": self._pid,
              "tid": tid}
        if phase == "f":
            ev["bp"] = "e"  # bind to the enclosing slice
        if self._native is not None:
            # the native writer carries the id in its value slot
            ev["args"] = {"value": int(flow_id)}
        self._put(ev)

    def flow_start(self, name: str, flow_id: int, tid: int = 0) -> None:
        """Open a cross-process flow arrow (``ph: "s"``); ``flow_id`` is
        the binding key both processes derive."""
        self._flow("s", name, flow_id, tid)

    def flow_finish(self, name: str, flow_id: int, tid: int = 0) -> None:
        """Close a flow arrow (``ph: "f"``, bound to the enclosing slice)."""
        self._flow("f", name, flow_id, tid)

    # -- writer side -------------------------------------------------------

    def _writer_loop(self) -> None:
        try:
            with open(self.path, "w") as f:
                f.write("[\n")
                sep = ""
                done = False
                while not done:
                    # wake on an event, then let the events of the next
                    # _DRAIN_S gather: the writer takes the GIL from the
                    # step that makes them once a batch, not once an event
                    batch = [self._q.get()]
                    time.sleep(_DRAIN_S)
                    while True:
                        try:
                            batch.append(self._q.get_nowait())
                        except queue.Empty:
                            break
                    lines = []
                    for ev in batch:
                        if ev is Timeline._SENTINEL:
                            done = True
                            break
                        lines.append(json.dumps(ev))
                    if lines:
                        f.write(sep + ",\n".join(lines))
                        sep = ",\n"
                        f.flush()
                f.write("\n]\n")
        except OSError as exc:  # disk full / bad prefix: drop, don't crash train
            self._failed = True
            logger.error("timeline writer failed, disabling timeline: %s", exc)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._native is not None:
            with self._native_mu:
                handle, self._native = self._native, None
            self._native_lib.bf_timeline_close(handle)
            return
        self._q.put(Timeline._SENTINEL)
        self._writer.join(timeout=5.0)


# -- module-level API mirroring bf.timeline_* (basics.py:308-388) -----------

# the runtime's state object, bound at first use: ``state`` imports modules
# that import this one
_STATE: list = []


def _timeline() -> Optional[Timeline]:
    if not _STATE:
        from .state import _global_state

        _STATE.append(_global_state())
    return _STATE[0].timeline


def timeline_start_activity(tensor_name: str, activity: str,
                            tid: int = 0) -> bool:
    tl = _timeline()
    if tl is None:
        return False
    tl.activity_start(tensor_name, activity, tid)
    return True


def timeline_end_activity(tensor_name: str, tid: int = 0) -> bool:
    tl = _timeline()
    if tl is None:
        return False
    tl.activity_end(tensor_name, tid)
    return True


def timeline_counter(name: str, value, tid: int = 0) -> bool:
    """Sample a chrome counter track (no-op when the timeline is off)."""
    tl = _timeline()
    if tl is None:
        return False
    tl.counter(name, int(value), tid)
    return True


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the metrics registry's counter ``name`` and, while the
    timeline is on, sample its value on the counter track of that name."""
    c = _metrics.counter(name)
    c.inc(n)
    timeline_counter(name, c.value)


def tracing() -> bool:
    """Whether a profiler runs (however it was started) or the timeline is
    on: the instruments too dear for every step record only then."""
    return torch.autograd._profiler_enabled() or _timeline() is not None


def _profiler_mark(label: str) -> None:
    """An empty ``record_function`` range, only while a profiler runs."""
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(label):
            pass


def timeline_flow_start(name: str, flow_id: int, tid: int = 0) -> bool:
    """Open flow ``flow_id`` (the timeline's ``ph: "s"``, and a
    ``<name>.s.<id>`` range under ``torch.profiler``)."""
    _profiler_mark(f"{name}.s.{int(flow_id)}")
    tl = _timeline()
    if tl is None:
        return False
    tl.flow_start(name, flow_id, tid)
    return True


def timeline_flow_finish(name: str, flow_id: int, tid: int = 0) -> bool:
    """Close flow ``flow_id`` (``ph: "f"``; ``<name>.f.<id>``)."""
    _profiler_mark(f"{name}.f.{int(flow_id)}")
    tl = _timeline()
    if tl is None:
        return False
    tl.flow_finish(name, flow_id, tid)
    return True


def timeline_instant(tensor_name: str, activity: str, tid: int = 0) -> bool:
    """Emit an instant event (stall warnings, membership transitions)."""
    tl = _timeline()
    if tl is None:
        return False
    tl.instant(tensor_name, activity, tid)
    return True


class timeline_context:
    """``with timeline_context(name, activity)``: one named span of the host
    in every reader that is on (the module's docstring).

    ``flight``: the name of the flight recorder's span too (``opt.pack``,
    ...); ``b``: the step it belongs to, in the flight span's aux column and
    the timeline event's ``args``, so the spans of one step share it."""

    __slots__ = ("_name", "_activity", "_tid", "_flight", "_b", "_rf",
                 "_tl", "_fl", "_nid")

    def __init__(self, tensor_name: str, activity: str, tid: int = 0, *,
                 flight: Optional[str] = None, b: int = 0) -> None:
        self._name = tensor_name
        self._activity = activity
        self._tid = tid
        self._flight = flight
        self._b = b

    # the flight span opens first and closes last, so a phase's time in
    # ``bf.step_report()`` holds what the other readers cost it
    def __enter__(self) -> "timeline_context":
        if self._flight is not None:
            self._fl = _flight.recorder()
            self._nid = self._fl.intern(self._flight)
            self._fl.rec(_flight.SPAN_B, self._nid, 0.0, self._b)
        self._tl = _timeline()
        if self._tl is not None:
            self._tl.activity_start(self._name, self._activity, self._tid,
                                    {"step": self._b} if self._b else None)
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(
                f"{self._name}.{self._activity}")
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._tl is not None:
            self._tl.activity_end(self._name, self._tid)
        if self._flight is not None:
            self._fl.rec(_flight.SPAN_E, self._nid, 0.0, self._b)
        return False


def start_timeline(prefix: str) -> bool:
    """Enable the timeline at run time (reference: basics.py timeline start)."""
    from .state import _global_state

    st = _global_state()
    if st.timeline is not None:
        logger.warning("timeline already running; ignoring start_timeline")
        return False
    st.timeline = Timeline(prefix)
    return True


def stop_timeline() -> bool:
    from .state import _global_state

    st = _global_state()
    if st.timeline is None:
        return False
    st.timeline.close()
    st.timeline = None
    return True
