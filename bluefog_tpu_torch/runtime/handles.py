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
host blocking.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch.distributed as dist


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


def allocate(name: str, work: Sequence, finalize: Callable[[], Any]) -> int:
    """Register an issued op's ``Work`` objects and its finalizer."""
    handle = next(_counter)
    entry = _Entry(name, work, finalize)
    with _lock:
        _handle_map[handle] = entry
    return handle


def clear() -> None:
    """Drop every handle (called by ``shutdown``)."""
    with _lock:
        _handle_map.clear()


def poll(handle: int) -> bool:
    """True when every transfer of the op behind ``handle`` has finished."""
    with _lock:
        entry = _handle_map.get(handle)
    if entry is None:
        raise ValueError(f"unknown or already-synchronized handle {handle}")
    return entry.ready()


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
    return entry.result()


def wait(handle: int, timeout: Optional[float] = None) -> Any:
    """Alias of :func:`synchronize` (reference: mpi_ops.py:857-869)."""
    return synchronize(handle, timeout)
