"""Stall watchdog: warns about nonblocking ops that never complete.

Counterpart of ``bluefog_tpu/runtime/watchdog.py``, the analog of
BlueFog's coordinator stall check (reference: CheckForStalledTensors,
operations.cc:387-432, cadence STALL_WARNING_TIME=60 s). The thread polls
the handle registry (``runtime/handles.py`` :func:`~handles.outstanding`)
for issued-but-unfinished ops; a handle stuck longer than
``BFT_STALL_WARNING_TIME`` seconds usually means a collective some rank
never joined. Each stalled handle is flagged once: a ``watchdog.stalls``
count, a ``STALL`` instant on the timeline, a warning, and one
``watchdog-stall`` flight dump for the batch (rate-limited). Each cycle
also closes the ``COMMUNICATE`` spans of finished handles nobody polled,
and, in a job without a heartbeat monitor, polls the remote dump trigger.
"""

from __future__ import annotations

import threading

from . import flight as _flight
from . import handles
from . import metrics as _metrics
from .logging import logger
from .timeline import timeline_instant


class StallWatchdog:
    def __init__(self, warning_sec: float = 60.0, cycle_ms: float = 0.5) -> None:
        self.warning_sec = warning_sec
        # Poll at >= 1 s: this thread is observability, not a dispatch
        # loop, so the reference's 0.5 ms cycle would be pure waste here.
        self.cycle_sec = max(cycle_ms / 1000.0, 1.0)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._warned: set[int] = set()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="bft-stall-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.cycle_sec):
            self._poll_flight_trigger()
            try:
                handles.sweep_completed_spans()
                pending = handles.outstanding()
            except Exception:  # never let observability kill the process
                continue
            # Forget warned handles that completed or left the table:
            # without this the set grows one int per stalled-then-finished
            # handle for the life of the job. A handle that leaves the
            # outstanding set and stalls again later (re-registered by a
            # timed-out synchronize) warns again: it progressed in between.
            self._warned.intersection_update(pending)
            stalled = {
                h: (name, age)
                for h, (name, age) in pending.items()
                if age > self.warning_sec and h not in self._warned
            }
            for h, (name, age) in stalled.items():
                self._warned.add(h)
                # a counter for the scrape and an instant in the trace,
                # right where the silence is
                _metrics.counter("watchdog.stalls").inc()
                timeline_instant(name, "STALL")
                logger.warning(
                    "op '%s' (handle %d) has not completed for %.0f s; "
                    "likely a hung collective (some rank absent)",
                    name, h, age)
            if stalled:
                # evidence of what led INTO the silence: the wedge may
                # never raise a Python exception to dump on (rate-limited;
                # one dump covers the whole stalled batch)
                _flight.recorder().instant("fatal.watchdog.stall")
                _flight.dump(reason="watchdog-stall", force=False)

    def _poll_flight_trigger(self) -> None:
        """The remote dump trigger's poll for jobs without a heartbeat
        monitor (one controller): there the watchdog is the only always-on
        cadence thread. Jobs of several controllers poll on the heartbeat
        tick."""
        try:
            from . import control_plane as _cp
            from .state import _global_state

            if _cp.active() and _global_state().peer_monitor is None:
                _flight.poll_remote_trigger(_cp.client())
        except Exception:  # noqa: BLE001 — observability thread
            pass
