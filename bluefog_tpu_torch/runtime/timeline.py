"""Chrome-tracing timeline.

Counterpart of ``bluefog_tpu/runtime/timeline.py``: named activities
streamed through a ``queue.SimpleQueue`` to a writer thread producing
chrome-tracing JSON (chrome://tracing or Perfetto). ``BFT_TIMELINE=<prefix>``
enables it at ``bf.init``, one file ``<prefix><rank>.json`` per process (the
port runs one process per rank), or :func:`start_timeline` at run time.
Every file starts with the ``bf.clock_sync_us`` counter, the wall clock at
ts=0, so ``scripts/merge_timelines.py`` lays the ranks' files on one axis.

:func:`timeline_context` also opens
``torch.profiler.record_function("<name>.<activity>")``, the counterpart of
the JAX package's ``jax.profiler.TraceAnnotation``: under ``torch.profiler``
the CUDA kernels a span issues land inside its named range. It does so
whether or not the timeline is on. A span times the host's issue of the
work, as the JAX package's spans time a jitted dispatch.
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from typing import Optional

import torch

from .logging import logger

# Counter-event name anchoring each per-process trace to the wall clock;
# scripts/merge_timelines.py keys on it to align files before merging.
CLOCK_SYNC_COUNTER = "bf.clock_sync_us"


class Timeline:
    """Streaming chrome-tracing writer with named activities per (name, lane)."""

    _SENTINEL = object()

    def __init__(self, prefix: str,
                 process_index: Optional[int] = None) -> None:
        if process_index is None:
            from .state import _global_state

            st = _global_state()
            process_index = st.rank if st.initialized else 0
        pid = process_index
        self.path = f"{prefix}{pid}.json"
        self._t0 = time.perf_counter_ns()
        self._pid = pid
        self._closed = False
        self._failed = False  # writer died: stop producing so the queue can't grow
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._writer = threading.Thread(
            target=self._writer_loop, name="bft-timeline-writer", daemon=True)
        self._writer.start()
        # Clock-sync anchor: the first event of every trace is a counter
        # carrying the wall-clock microseconds at (about) ts=0.
        self.counter(CLOCK_SYNC_COUNTER, time.time_ns() // 1000)

    # -- producer side (any thread) ---------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _put(self, ev: dict) -> None:
        if not (self._failed or self._closed):
            self._q.put(ev)

    def activity_start(self, tensor_name: str, activity: str,
                       tid: int = 0) -> None:
        self._put({"name": activity, "cat": tensor_name, "ph": "B",
                   "ts": self._now_us(), "pid": self._pid, "tid": tid})

    def activity_end(self, tensor_name: str, tid: int = 0) -> None:
        self._put({"ph": "E", "ts": self._now_us(), "pid": self._pid,
                   "tid": tid, "cat": tensor_name})

    def counter(self, name: str, value: int, tid: int = 0) -> None:
        """Chrome counter-track sample (``ph: "C"``): the metrics gauges
        and the clock-sync anchor ride these."""
        self._put({"name": name, "cat": "bf", "ph": "C", "ts": self._now_us(),
                   "pid": self._pid, "tid": tid,
                   "args": {"value": int(value)}})

    # -- writer side -------------------------------------------------------

    def _writer_loop(self) -> None:
        try:
            with open(self.path, "w") as f:
                f.write("[\n")
                first = True
                while True:
                    ev = self._q.get()
                    if ev is Timeline._SENTINEL:
                        break
                    if not first:
                        f.write(",\n")
                    f.write(json.dumps(ev))
                    first = False
                    f.flush()
                f.write("\n]\n")
        except OSError as exc:  # disk full / bad prefix: drop, don't crash train
            self._failed = True
            logger.error("timeline writer failed, disabling timeline: %s", exc)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(Timeline._SENTINEL)
        self._writer.join(timeout=5.0)


# -- module-level API mirroring bf.timeline_* (basics.py:308-388) -----------

def _timeline() -> Optional[Timeline]:
    from .state import _global_state

    return _global_state().timeline


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


@contextlib.contextmanager
def timeline_context(tensor_name: str, activity: str, tid: int = 0):
    """Named span in the host timeline AND the torch.profiler trace."""
    tl = _timeline()
    with torch.profiler.record_function(f"{tensor_name}.{activity}"):
        if tl is not None:
            tl.activity_start(tensor_name, activity, tid)
        try:
            yield
        finally:
            if tl is not None:
                tl.activity_end(tensor_name, tid)


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
