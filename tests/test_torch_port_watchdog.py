"""Port vs JAX: the stall watchdog, the span sweep and ``synchronize``'s
deadline.

The counterparts of ``tests/test_watchdog.py``'s five tests run the port's
``runtime/watchdog.py`` over the port's handle table: an op whose transfers
never complete is flagged once (a warning naming it, ``watchdog.stalls``,
a ``STALL`` timeline instant and a ``watchdog-stall`` flight dump), its
warned entry is dropped once it completes, and ``poll``/``synchronize``
keep their consume-once contract. A port handle holds ``Work`` objects, so
the stand-ins are works whose ``is_completed()`` the test controls.

Then what the port's ``runtime/handles.py`` gains with the watchdog, held
against JAX's ``handles`` on the same scenario: the sweep closes the span
of a finished handle nobody polled but never one an in-flight
``synchronize`` has claimed; an expired deadline (``BFT_SYNC_TIMEOUT`` for
``BLUEFOG_SYNC_TIMEOUT``) leaves the handle valid, raises a plain
``RuntimeError`` with the "no peer is reported dead" diagnosis, or, with a
controller dead, a ``PeerLostError`` after a ``fatal`` dump, in both
packages.
"""

import json
import logging
import threading
import time

import pytest

from bluefog_tpu.runtime import handles as jhandles
from bluefog_tpu.runtime import native as jnative
from bluefog_tpu.runtime.state import _global_state as jstate
from bluefog_tpu_torch.runtime import flight, handles, metrics, native
from bluefog_tpu_torch.runtime.logging import logger
from bluefog_tpu_torch.runtime.state import _global_state
from bluefog_tpu_torch.runtime.watchdog import StallWatchdog

_WAIT_S = 10.0


class _Work:
    """Stands in for a ``torch.distributed.Work`` whose transfer finishes
    when the test says so."""

    def __init__(self, done: bool = False) -> None:
        self.done = done

    def is_completed(self) -> bool:
        return self.done

    def wait(self) -> bool:
        return True


def _alloc(name: str, done: bool = False):
    w = _Work(done)
    return handles.allocate(name, [w], lambda: name), w


@pytest.fixture(autouse=True)
def _clean_handles(tmp_path, monkeypatch):
    # a stall's dump lands in the test's directory, not the working one
    monkeypatch.setenv("BFT_FLIGHT_DIR", str(tmp_path))
    handles.clear()
    yield
    handles.clear()


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)


class _Timeline:
    """Records the span edges the handles emit (a timeline stand-in)."""

    def __init__(self):
        self.edges = []

    def activity_start(self, name, activity, tid=0):
        self.edges.append(("B", name, tid))

    def activity_end(self, name, tid=0):
        self.edges.append(("E", name, tid))

    def instant(self, name, activity, tid=0):
        self.edges.append(("i", name, activity))


def _wait_for(cond) -> bool:
    deadline = time.monotonic() + _WAIT_S
    while time.monotonic() < deadline and not cond():
        time.sleep(0.1)
    return cond()


def test_outstanding_tracks_only_unfinished():
    h1, _ = _alloc("op.stuck")
    h2, _ = _alloc("op.done", done=True)
    out = handles.outstanding()
    assert h1 in out and h2 not in out
    name, age = out[h1]
    assert name == "op.stuck" and age >= 0.0


def test_watchdog_warns_once_per_stalled_handle(monkeypatch):
    # the package logger does not propagate: capture with our own handler
    cap = _Capture()
    logger.addHandler(cap)
    tl = _Timeline()
    monkeypatch.setattr(_global_state(), "timeline", tl)
    stalls0 = metrics.counter("watchdog.stalls").value
    h, w = _alloc("op.hung")
    wd = StallWatchdog(warning_sec=0.05, cycle_ms=1.0)  # poll floor is 1 s
    try:
        wd.start()
        assert _wait_for(lambda: any("op.hung" in r.getMessage()
                                     for r in cap.records))
        # further cycles must NOT warn about the same handle again
        time.sleep(2.2)
        warns = [r for r in cap.records if "op.hung" in r.getMessage()]
        assert len(warns) == 1, f"expected one warning, got {len(warns)}"
        assert metrics.counter("watchdog.stalls").value == stalls0 + 1
        assert [e for e in tl.edges if e[0] == "i"] == [
            ("i", "op.hung", "STALL")]
    finally:
        wd.stop()
        logger.removeHandler(cap)
    w.done = True
    assert handles.synchronize(h) == "op.hung"


def test_warned_set_pruned_after_completion():
    """The warned set does not grow for the life of the job: a handle that
    completed leaves it, and a re-registered stalled handle warns again."""
    cap = _Capture()
    logger.addHandler(cap)
    h, w = _alloc("op.leaky")
    wd = StallWatchdog(warning_sec=0.05, cycle_ms=1.0)
    try:
        wd.start()
        assert _wait_for(lambda: h in wd._warned)
        w.done = True  # completing the op must prune its warned entry
        assert _wait_for(lambda: h not in wd._warned), \
            "completed handle leaked in _warned"
        h2, w2 = _alloc("op.leaky2")
        assert _wait_for(lambda: any("op.leaky2" in r.getMessage()
                                     for r in cap.records))
        w2.done = True
        handles.synchronize(h2)
    finally:
        wd.stop()
        logger.removeHandler(cap)
    handles.synchronize(h)


def test_stall_triggers_flight_dump(tmp_path, monkeypatch):
    """A watchdog-detected stall leaves a flight dump behind: the wedge
    may never raise a Python exception to dump on."""
    monkeypatch.setenv("BFT_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("BFT_FLIGHT_MIN_INTERVAL", "0")
    flight.reset_for_job()
    h, w = _alloc("op.wedged")
    wd = StallWatchdog(warning_sec=0.05, cycle_ms=1.0)
    try:
        wd.start()
        dump_path = tmp_path / "bf_flight_0.json"
        assert _wait_for(dump_path.exists), "stall produced no flight dump"
        doc = json.loads(dump_path.read_text())
        assert doc["meta"]["reason"] == "watchdog-stall"
        names = doc["names"]
        instants = [names[n] for k, n in zip(doc["events"]["kind"],
                                             doc["events"]["name"])
                    if k == flight.INSTANT]
        assert "fatal.watchdog.stall" in instants
    finally:
        wd.stop()
        flight.reset_for_job()
    w.done = True
    handles.synchronize(h)


def test_poll_and_synchronize_contract():
    h, _ = _alloc("op.x", done=True)
    assert handles.poll(h) is True
    handles.synchronize(h)
    with pytest.raises(ValueError):
        handles.poll(h)
    with pytest.raises(ValueError):
        handles.synchronize(h)


# ---------------------------------------------------------------------------
# the span sweep and synchronize's deadline, against JAX's handles
# ---------------------------------------------------------------------------

def test_sweep_closes_unpolled_spans_but_not_a_claimed_one(monkeypatch):
    tl = _Timeline()
    monkeypatch.setattr(_global_state(), "timeline", tl)
    h_done, _ = _alloc("op.fire_and_forget", done=True)
    h_wait, w = _alloc("op.awaited")
    assert [e[0] for e in tl.edges] == ["B", "B"]
    # a synchronize claims op.awaited's span while it waits
    got = []
    t = threading.Thread(target=lambda: got.append(
        handles.synchronize(h_wait, timeout=5.0)))
    t.start()
    time.sleep(0.2)
    handles.sweep_completed_spans()
    ends = [e[1] for e in tl.edges if e[0] == "E"]
    assert ends == ["op.fire_and_forget"]  # the claimed span stayed open
    w.done = True
    t.join(timeout=_WAIT_S)
    assert got == ["op.awaited"]
    ends = [e[1] for e in tl.edges if e[0] == "E"]
    assert ends == ["op.fire_and_forget", "op.awaited"]
    handles.synchronize(h_done)
    assert len(tl.edges) == 4  # no edge emitted twice


class _NeverReady:
    def is_ready(self):
        return False


class _Monitor:
    """A peer monitor stand-in whose dead set the test sets."""

    def __init__(self, dead):
        self.dead = set(dead)

    def dead_peers(self):
        return set(self.dead)


@pytest.mark.parametrize("dead", [set(), {1}])
def test_deadline_diagnosis_against_jax(dead, tmp_path, monkeypatch):
    """The same stalled op in both packages: an expired deadline (the
    ``*_SYNC_TIMEOUT`` default) keeps the handle and names the diagnosis;
    with controller 1 dead both raise ``PeerLostError`` and dump
    ``fatal.synchronize``. The port's ``dead`` names the dead set (JAX's
    is left empty; its message names them)."""
    monkeypatch.setenv("BFT_SYNC_TIMEOUT", "0.2")
    monkeypatch.setenv("BLUEFOG_SYNC_TIMEOUT", "0.2")
    monkeypatch.setenv("BFT_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("BFT_FLIGHT_MIN_INTERVAL", "0")
    flight.reset_for_job()
    monkeypatch.setattr(_global_state(), "peer_monitor", _Monitor(dead))
    monkeypatch.setattr(jstate(), "peer_monitor", _Monitor(dead))
    h, w = _alloc("op.stalled")
    jh = jhandles.allocate("op.stalled", _NeverReady())
    try:
        errors = []
        for sync, handle in ((handles.synchronize, h),
                             (jhandles.synchronize, jh)):
            t0 = time.monotonic()
            with pytest.raises(RuntimeError) as ei:
                sync(handle)
            assert 0.2 <= time.monotonic() - t0 < 5.0
            errors.append(ei.value)
        port_exc, jax_exc = errors
        assert (type(port_exc) is native.PeerLostError) == bool(dead)
        assert (type(jax_exc) is jnative.PeerLostError) == bool(dead)
        for exc in errors:
            msg = str(exc)
            assert "synchronize('op.stalled'" in msg
            assert "exceeded the 0.2s deadline" in msg
            if dead:
                assert "controller process(es) [1] are DEAD" in msg
            else:
                assert "no peer is reported dead" in msg
        if dead:
            assert port_exc.dead == {1} and jax_exc.dead == set()
            doc = json.loads((tmp_path / "bf_flight_0.json").read_text())
            assert doc["meta"]["reason"] == "synchronize: PeerLostError"
        else:
            assert not (tmp_path / "bf_flight_0.json").exists()
        # both handles stayed valid: the retry finds them
        assert h in handles.outstanding() and jh in jhandles.outstanding()
        w.done = True
        assert handles.synchronize(h, timeout=1.0) == "op.stalled"
    finally:
        jhandles.clear()
        flight.reset_for_job()
