"""Handles of nonblocking ops: ``poll`` / ``synchronize`` / ``wait``.

Counterpart of ``bluefog_tpu/runtime/handles.py`` (:124-245). A
``*_nonblocking`` op issues its transfers and returns an integer handle.
The handle holds the op's ``torch.distributed.Work`` objects (from
``async_op=True``, or the list ``batch_isend_irecv`` returns) and a
finalizer that forms the result once they are done: the weighted sum, the
trim, the cast back.

``synchronize`` consumes a handle once; a second call raises
``ValueError``. With a ``timeout`` it polls until the deadline and, on
expiry, raises ``RuntimeError`` and leaves the handle valid for a retry, as
the JAX package does. Under NCCL ``Work.wait()`` orders the current stream
after the transfer, so the finalizer's kernels run after it without the
host blocking. A transfer that fails raises out of ``synchronize`` after a
flight-recorder dump (``runtime/flight.py``).

With the timeline on, each handle opens a ``COMMUNICATE`` span under its
op's name when it is issued, on a lane (tid) of its own, closed when
``poll`` first finds the op done or ``synchronize`` returns (JAX
``handles.py:40-80``); ``shutdown`` closes the ones still open. The JAX
package's stall watchdog also closes the spans of handles nobody waits on;
the port has no watchdog, so those stay open until ``shutdown``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from . import flight as _flight
from .timeline import timeline_end_activity, timeline_start_activity


class _Entry:
    """One issued op. Under gloo a point-to-point ``Work`` reports
    completion only once waited on, so a waiter thread waits on the op's
    ``Work`` objects and ``done`` says when they have finished; under NCCL
    ``Work.is_completed()`` queries the transfer's CUDA event."""

    def __init__(self, name: str, work: Sequence,
                 finalize: Callable[[], Any]) -> None:
        self.name = name
        self.work = list(work)
        self.finalize = finalize
        self.done: Optional[threading.Event] = None
        self.error: Optional[BaseException] = None
        if self.work and dist.get_backend() == "gloo":
            self.done = threading.Event()
            threading.Thread(target=self._wait_all, daemon=True).start()

    def _wait_all(self) -> None:
        try:
            for w in self.work:
                w.wait()
        except Exception as e:  # re-raised by synchronize in the caller
            self.error = e
        finally:
            self.done.set()

    def ready(self) -> bool:
        if self.done is not None:
            return self.done.is_set()
        return all(w.is_completed() for w in self.work)

    def result(self) -> Any:
        """Wait for the op (it is ready under gloo) and form its result."""
        if self.done is None:
            for w in self.work:
                w.wait()
        else:
            self.done.wait()
            if self.error is not None:
                raise self.error
        return self.finalize()


_lock = threading.Lock()
_counter = itertools.count(1)
_handle_map: Dict[int, _Entry] = {}

# handle -> (op name, tid lane) of its open COMMUNICATE span. Lanes come
# from a free list so concurrent spans never share a tid (a trace viewer
# pairs an E with the latest B on its tid); a lane is reused only after
# its span closes.
_open_spans: Dict[int, Tuple[str, int]] = {}
_free_lanes: list = []
_lane_counter = itertools.count(1000)


def _open_span(handle: int, name: str) -> None:
    with _lock:
        tid = _free_lanes.pop() if _free_lanes else next(_lane_counter)
        _open_spans[handle] = (name, tid)
    if not timeline_start_activity(name, "COMMUNICATE", tid):
        with _lock:  # timeline off: nothing to close later
            _open_spans.pop(handle, None)
            _free_lanes.append(tid)


def _close_span(handle: int) -> None:
    with _lock:
        span = _open_spans.pop(handle, None)
    if span is None:
        return
    name, tid = span
    timeline_end_activity(name, tid)
    with _lock:
        _free_lanes.append(tid)


def close_all_spans() -> None:
    """Emit the closing edge of every open span (``shutdown``, before the
    timeline closes, so the trace stays balanced)."""
    with _lock:
        open_handles = list(_open_spans)
    for handle in open_handles:
        _close_span(handle)


def allocate(name: str, work: Sequence, finalize: Callable[[], Any]) -> int:
    """Register an issued op's ``Work`` objects and its finalizer."""
    handle = next(_counter)
    entry = _Entry(name, work, finalize)
    with _lock:
        _handle_map[handle] = entry
    _open_span(handle, name)
    return handle


def clear() -> None:
    """Drop every handle (called by ``shutdown``)."""
    close_all_spans()
    with _lock:
        _handle_map.clear()


def poll(handle: int) -> bool:
    """True when every transfer of the op behind ``handle`` has finished."""
    with _lock:
        entry = _handle_map.get(handle)
    if entry is None:
        raise ValueError(f"unknown or already-synchronized handle {handle}")
    done = entry.ready()
    if done:
        _close_span(handle)
    return done


def synchronize(handle: int, timeout: Optional[float] = None) -> Any:
    """Wait for the op behind ``handle`` and return its result.

    ``timeout`` (seconds; None waits as long as the op takes) bounds the
    wait: on expiry the handle stays valid and ``RuntimeError`` is raised.
    """
    # atomic pop: of two concurrent calls on one handle exactly one wins
    with _lock:
        entry = _handle_map.pop(handle, None)
    if entry is None:
        raise ValueError(f"unknown or already-synchronized handle {handle}")
    if timeout is not None:
        deadline = time.monotonic() + timeout
        # checked once more after the deadline, so timeout=0 polls once
        while not entry.ready():
            if time.monotonic() >= deadline:
                with _lock:
                    _handle_map[handle] = entry
                raise RuntimeError(
                    f"synchronize('{entry.name}', handle {handle}) exceeded "
                    f"the {timeout:.1f}s deadline; the handle stays valid")
            time.sleep(0.001)
    try:
        out = entry.result()
    except Exception as exc:
        # black-box dump before the caller decides what to do with the
        # failed transfer: the ring's tail is the evidence
        _flight.fatal("synchronize", exc)
        raise
    finally:
        _close_span(handle)
    return out


def wait(handle: int, timeout: Optional[float] = None) -> Any:
    """Alias of :func:`synchronize` (reference: mpi_ops.py:857-869)."""
    return synchronize(handle, timeout)
