"""Handles of nonblocking ops: ``poll`` / ``synchronize`` / ``wait``.

Counterpart of ``bluefog_tpu/runtime/handles.py``. A ``*_nonblocking`` op
issues its transfers and returns an integer handle. The handle holds the
op's ``torch.distributed.Work`` objects (from ``async_op=True``, or the
list ``batch_isend_irecv`` returns) and a finalizer that forms the result
once they are done: the weighted sum, the trim, the cast back.

``synchronize`` consumes a handle once; a second call raises
``ValueError``. Its ``timeout`` (seconds; default ``BFT_SYNC_TIMEOUT``,
unset waits as long as the op takes) bounds the wait: on expiry the handle
is registered again under the same id for a retry, and the error carries
the failure detector's diagnosis. With a controller dead
(``runtime/heartbeat.py``) it is a ``PeerLostError`` whose ``dead`` names
the dead controllers, after a flight-recorder dump; otherwise a plain
``RuntimeError``. Under NCCL ``Work.wait()`` orders the current stream
after the transfer, so the finalizer's kernels run after it without the
host blocking. A transfer that fails raises out of ``synchronize`` after a
flight-recorder dump (``runtime/flight.py``): as a ``PeerLostError`` when
a controller is dead by then, and with a deadline it waits, until the
deadline, for the detector to name one (a peer's death closes its
connections before the heartbeat's timeout passes).

With the timeline on, each handle opens a ``COMMUNICATE`` span under its
op's name when it is issued, on a lane (tid) of its own, closed when
``poll`` first finds the op done, when ``synchronize`` returns, or by the
stall watchdog's sweep (``runtime/watchdog.py``) for a finished handle
nobody waits on (JAX ``handles.py:40-95``); ``shutdown`` closes the ones
still open. A span claimed by an in-flight ``synchronize`` is out of the
sweep's reach.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from . import flight as _flight
from .config import knob_env
from .heartbeat import dead_controllers
from .timeline import timeline_end_activity, timeline_start_activity


class _Entry:
    """One issued op. Under gloo a point-to-point ``Work`` reports
    completion only once waited on, so a waiter thread waits on the op's
    ``Work`` objects and ``done`` says when they have finished; under NCCL
    ``Work.is_completed()`` queries the transfer's CUDA event."""

    def __init__(self, name: str, work: Sequence,
                 finalize: Callable[[], Any]) -> None:
        self.name = name
        self.t0 = time.monotonic()
        self.work = list(work)
        self.finalize = finalize
        self.done: Optional[threading.Event] = None
        self.error: Optional[BaseException] = None
        if self.work and dist.is_initialized() and \
                dist.get_backend() == "gloo":
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

    def failed(self) -> bool:
        """A transfer raised (gloo: its waiter caught the error)."""
        return self.done is not None and self.done.is_set() and \
            self.error is not None

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


def _take_span(handle: int) -> Optional[Tuple[str, int]]:
    """Claim the span (``synchronize`` owns its closing edge from here on;
    the watchdog's sweep can no longer touch it)."""
    with _lock:
        return _open_spans.pop(handle, None)


def _restore_span(handle: int, span: Optional[Tuple[str, int]]) -> None:
    if span is not None:
        with _lock:
            _open_spans[handle] = span


def _emit_span_end(span: Optional[Tuple[str, int]]) -> None:
    if span is None:
        return
    name, tid = span
    timeline_end_activity(name, tid)
    with _lock:
        _free_lanes.append(tid)


def _close_span(handle: int) -> None:
    _emit_span_end(_take_span(handle))


def sweep_completed_spans() -> None:
    """Close the ``COMMUNICATE`` spans of finished handles nobody polled
    (the stall watchdog's cycle calls this). Spans claimed by an in-flight
    ``synchronize`` are no longer in the table, so the sweep cannot cut
    them short."""
    with _lock:
        candidates = [(h, _handle_map.get(h)) for h in list(_open_spans)]
    for h, entry in candidates:
        if entry is None or entry.ready():
            _close_span(h)


def close_all_spans() -> None:
    """Emit the closing edge of every open span (``shutdown``, before the
    timeline closes, so the trace stays balanced)."""
    with _lock:
        spans = list(_open_spans.values())
        _open_spans.clear()
    for span in spans:
        _emit_span_end(span)


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

    ``timeout`` (seconds; default ``BFT_SYNC_TIMEOUT``, unset waits as long
    as the op takes) bounds the wait: on expiry the handle stays valid for
    a retry and the error names the failure detector's diagnosis, a
    ``PeerLostError`` (a ``RuntimeError``) when a controller is dead, else
    a plain ``RuntimeError``. The reference only warns about stalls
    (CheckForStalledTensors, operations.cc:387-432); this makes the stall
    a failure the caller can attribute.
    """
    if timeout is None:
        timeout = knob_env("BFT_SYNC_TIMEOUT")
    # atomic pop: of two concurrent calls on one handle exactly one wins
    with _lock:
        entry = _handle_map.pop(handle, None)
    if entry is None:
        raise ValueError(f"unknown or already-synchronized handle {handle}")
    # claim the COMMUNICATE span: this call owns its closing edge now, so
    # the watchdog's sweep (which takes a missing entry for done) cannot
    # cut it short while we wait
    span = _take_span(handle)
    if timeout is not None:
        deadline = time.monotonic() + timeout
        # Checked once more after the deadline, so timeout=0 polls once. A
        # peer's death reaches the transport (a closed connection) sooner
        # than the heartbeat's timeout: a failed op waits, until the
        # deadline, for the detector to name the dead controller, so the
        # caller gets the typed error either way.
        while not entry.ready() or (entry.failed()
                                    and not dead_controllers()):
            if time.monotonic() >= deadline:
                if entry.failed():
                    break  # the transfer's own error, raised below
                # re-register under the same id (span included) so the
                # caller can retry
                with _lock:
                    _handle_map[handle] = entry
                _restore_span(handle, span)
                raise _deadline_error(entry, handle, timeout)
            time.sleep(0.001)
    try:
        out = entry.result()
    except Exception as exc:
        dead = dead_controllers()
        if not dead:
            # black-box dump before the caller decides what to do with
            # the failed transfer: the ring's tail is the evidence
            _flight.fatal("synchronize", exc)
            raise
        lost = _peer_lost_error(
            f"synchronize('{entry.name}', handle {handle}) failed "
            f"({type(exc).__name__}: {exc}): controller process(es) "
            f"{sorted(dead)} are DEAD (heartbeat silence)", dead)
        raise lost from exc
    finally:
        _emit_span_end(span)
    return out


def _deadline_error(entry: _Entry, handle: int,
                    timeout: float) -> RuntimeError:
    """The error of an expired deadline, with the heartbeat's diagnosis; a
    ``PeerLostError`` after a flight dump when a controller is dead."""
    dead = dead_controllers()
    diagnosis = (
        f"controller process(es) {sorted(dead)} are DEAD (heartbeat "
        "silence): the collective can never complete; abandon the handle "
        "and tear down" if dead else
        "no peer is reported dead: the op may be slow, the job "
        "overloaded, or a peer controller may not have issued the same op "
        "(see enable_topo_check / the stall watchdog)")
    msg = (f"synchronize('{entry.name}', handle {handle}) exceeded the "
           f"{timeout:.1f}s deadline after "
           f"{time.monotonic() - entry.t0:.1f}s in flight: {diagnosis}")
    if not dead:
        return RuntimeError(msg)
    return _peer_lost_error(msg, dead)


def _peer_lost_error(msg: str, dead: set) -> RuntimeError:
    """``PeerLostError(msg, dead)`` after a flight dump. Typed: callers tell
    "the peer is gone, degrade the topology" from a slow op; a
    ``RuntimeError`` subclass, so existing handlers keep working."""
    from .native import PeerLostError

    exc = PeerLostError(msg, dead=dead)
    # black-box dump before the caller decides what to do with the dead
    # peer: the ring's tail is the evidence of what hung
    _flight.fatal("synchronize", exc)
    return exc


def wait(handle: int, timeout: Optional[float] = None) -> Any:
    """Alias of :func:`synchronize` (reference: mpi_ops.py:857-869)."""
    return synchronize(handle, timeout)


def outstanding() -> Dict[int, Tuple[str, float]]:
    """Unfinished handles: handle -> (op name, age in seconds)."""
    now = time.monotonic()
    with _lock:
        items = list(_handle_map.items())
    return {h: (e.name, now - e.t0) for h, e in items if not e.ready()}
