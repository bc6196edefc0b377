"""Port vs JAX: controller heartbeats, failure detection, gated rejoin and
coordinated shutdown over one control-plane server.

The counterparts of ``tests/test_heartbeat.py``'s seven tests run the
port's ``runtime/heartbeat.py`` over the port's server and clients: two
``PeerMonitor`` instances stand in for two controller processes, a stopped
heart is detected, a resumed one is only a suspect until a new incarnation
registered and completed quarantine, and a shutdown flag published by one
side is seen and acked by the other.

Then a mixed pair on one server, each way round: a JAX ``PeerMonitor`` and
a port ``PeerMonitor`` (explicit ``interval_sec``/``timeout_sec``) watch
each other. The one whose peer stops ticking declares it dead; the peer's
resumed heartbeat makes it a suspect; only the peer's re-attach under a new
incarnation and its own package's ``enter_quarantine`` and
``complete_quarantine`` re-admit it, each transition bumping the shared
membership epoch; and each sees the other's shutdown flag. The two packages
share the KV keys and values, so no adapter sits between them.
"""

import socket
import time

import pytest

from bluefog_tpu.runtime import control_plane as jcp
from bluefog_tpu.runtime import heartbeat as jheartbeat
from bluefog_tpu.runtime import native as jnative
from bluefog_tpu_torch.runtime import control_plane as cp
from bluefog_tpu_torch.runtime import heartbeat, native

# detection waits: a few timeouts of the monitors below, far inside a test
_WAIT_S = 5.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture()
def two_clients():
    port = _free_port()
    server = native.ControlPlaneServer(2, port)
    a = native.ControlPlaneClient("127.0.0.1", port, 0)
    b = native.ControlPlaneClient("127.0.0.1", port, 1)
    yield a, b
    a.close()
    b.close()
    server.stop()


def _attach(monkeypatch, client):
    """Point the port's control-plane singleton at a raw client."""
    monkeypatch.setattr(cp, "_client", client)


def _tick_until(mon, cond, beat=None):
    deadline = time.monotonic() + _WAIT_S
    while time.monotonic() < deadline and not cond():
        time.sleep(0.05)
        if beat is not None:
            beat()
        mon._tick()
    return cond()


def test_peer_failure_detected_and_gated_recovery(two_clients, monkeypatch):
    """Death is detected; a raw heartbeat resume alone does NOT re-admit:
    the peer is a suspect until a new incarnation registered and its
    quarantine completed."""
    a, b = two_clients
    _attach(monkeypatch, a)
    mon = heartbeat.PeerMonitor(0, 2, interval_sec=0.05, timeout_sec=0.3)

    def beat():
        b.put("bf.hb.1", int(time.monotonic_ns()))

    beat()
    mon._tick()
    assert mon.dead_peers() == set()
    epoch0 = mon.membership_epoch
    assert _tick_until(mon, lambda: 1 in mon.dead_peers())
    assert mon.dead_peers() == {1}
    assert mon.membership_epoch > epoch0  # death bumped the epoch

    # a resumed heartbeat makes a suspect, never a live peer
    beat()
    mon._tick()
    assert mon.dead_peers() == {1}
    assert mon.suspect_peers() == {1}
    beat()
    mon._tick()  # still gated on later ticks
    assert mon.dead_peers() == {1}

    # the gate: a NEW incarnation registers, then completes quarantine
    b.put("bf.inc.1", 1)
    beat()
    mon._tick()
    assert mon.dead_peers() == {1}, "registration alone must not re-admit"
    b.put("bf.q.1.1", 2)
    epoch1 = mon.membership_epoch
    beat()
    mon._tick()
    assert mon.dead_peers() == set()
    assert mon.suspect_peers() == set()
    assert mon.membership_epoch > epoch1  # re-admission bumped the epoch


def test_shutdown_flag_propagates_and_acks(two_clients, monkeypatch):
    a, b = two_clients
    _attach(monkeypatch, a)
    mon = heartbeat.PeerMonitor(0, 2, interval_sec=0.05, timeout_sec=10.0)
    mon._tick()
    assert not mon.shutdown_seen
    b.put("bf.shutdown.flag.1", 1)  # "process 1" announces
    mon._tick()
    assert mon.shutdown_seen
    # the monitor acked, so the announcer's bounded wait can return
    assert b.get("bf.shutdown.ack.0") == 1


def test_announcer_waits_for_ack_then_returns(two_clients, monkeypatch):
    a, b = two_clients
    _attach(monkeypatch, a)
    b.put("bf.shutdown.ack.1", 1)  # the peer already acked
    t0 = time.monotonic()
    heartbeat.announce_shutdown(0, 2, grace_sec=5.0)
    assert time.monotonic() - t0 < 1.0
    assert a.get("bf.shutdown.flag.0") == 1


def test_announcer_grace_bounds_the_wait(two_clients, monkeypatch):
    a, b = two_clients
    _attach(monkeypatch, a)
    t0 = time.monotonic()
    heartbeat.announce_shutdown(0, 2, grace_sec=0.3)  # nobody ever acks
    dt = time.monotonic() - t0
    assert 0.25 <= dt < 3.0


def test_second_announcer_skips_the_wait(two_clients, monkeypatch):
    a, b = two_clients
    _attach(monkeypatch, a)
    b.put("bf.shutdown.flag.1", 1)  # the peer announced first
    t0 = time.monotonic()
    heartbeat.announce_shutdown(0, 2, grace_sec=5.0)
    assert time.monotonic() - t0 < 1.0


def test_monitor_thread_lifecycle(two_clients, monkeypatch):
    a, b = two_clients
    _attach(monkeypatch, a)
    mon = heartbeat.PeerMonitor(0, 2, interval_sec=0.02, timeout_sec=10.0)
    mon.start()
    try:
        deadline = time.monotonic() + _WAIT_S
        while time.monotonic() < deadline and b.get("bf.hb.0") == 0:
            time.sleep(0.02)
        assert b.get("bf.hb.0") != 0, "monitor never published a heartbeat"
    finally:
        mon.stop()


def test_announce_shutdown_noop_without_control_plane(monkeypatch):
    _attach(monkeypatch, None)
    heartbeat.announce_shutdown(0, 2)  # must not raise
    assert heartbeat.shutdown_requested() is False
    assert heartbeat.dead_controllers() == set()
    assert heartbeat.dead_ranks() == set()
    assert heartbeat.membership_epoch() == 0


# ---------------------------------------------------------------------------
# a JAX monitor and a port monitor on one server
# ---------------------------------------------------------------------------

_PKG = {"jax": (jheartbeat, jnative, jcp), "port": (heartbeat, native, cp)}


@pytest.mark.skipif(jnative.load() is None,
                    reason="the JAX package's native runtime is unavailable")
@pytest.mark.parametrize("dying", ["port", "jax"])
def test_mixed_pair_death_gated_rejoin_and_shutdown(dying, monkeypatch):
    """Controller 1 runs the ``dying`` package, controller 0 the other.
    Controller 1 stops ticking: controller 0's monitor declares it dead
    within its timeout; its resumed heartbeat makes it a suspect that stays
    dead through its re-attach under incarnation 1 and its quarantine
    entry; ``complete_quarantine`` re-admits it, each transition bumping
    the epoch. Then each side's shutdown flag reaches the other."""
    watch = "jax" if dying == "port" else "port"
    whb, wnat, wcp = _PKG[watch]
    dhb, dnat, dcp = _PKG[dying]
    port = _free_port()
    server = native.ControlPlaneServer(2, port)
    wcl = wnat.ControlPlaneClient("127.0.0.1", port, 0)
    dcl = dnat.ControlPlaneClient("127.0.0.1", port, 1)
    dcl1 = None
    try:
        monkeypatch.setattr(wcp, "_client", wcl)
        monkeypatch.setattr(dcp, "_client", dcl)
        wmon = whb.PeerMonitor(0, 2, interval_sec=0.05, timeout_sec=0.3)
        dmon = dhb.PeerMonitor(1, 2, interval_sec=0.05, timeout_sec=0.3)
        for _ in range(2):
            dmon._tick()
            wmon._tick()
        assert wmon.dead_peers() == set() and dmon.dead_peers() == set()

        # controller 1 goes silent
        epochs = [wmon.membership_epoch]
        t0 = time.monotonic()
        assert _tick_until(wmon, lambda: wmon.dead_peers() == {1})
        assert time.monotonic() - t0 >= 0.3
        epochs.append(wmon.membership_epoch)

        # its heartbeat resumes: a suspect, still dead
        dmon._tick()
        wmon._tick()
        assert wmon.suspect_peers() == {1} and wmon.dead_peers() == {1}
        epochs.append(wmon.membership_epoch)

        # it re-attaches as incarnation 1 (the server mirrors bf.inc.1 and
        # bumps the epoch) and enters quarantine: still fenced
        dcl1 = dnat.ControlPlaneClient("127.0.0.1", port, 1, incarnation=1)
        assert wcl.get("bf.inc.1") == 1
        monkeypatch.setattr(dcp, "_client", dcl1)
        monkeypatch.setattr(dcp, "_incarnation", 1)
        dhb.enter_quarantine(1)
        assert dhb.quarantine_pending()
        assert wcl.get("bf.q.1.1") == 1
        for _ in range(3):
            dmon._tick()
            wmon._tick()
        assert wmon.suspect_peers() == {1} and wmon.dead_peers() == {1}

        # state transfer done: re-admitted at the next tick
        dhb.complete_quarantine()
        assert not dhb.quarantine_pending()
        assert wcl.get("bf.q.1.1") == 2
        dmon._tick()
        wmon._tick()
        assert wmon.suspect_peers() == set() and wmon.dead_peers() == set()
        epochs.append(wmon.membership_epoch)
        assert epochs == sorted(set(epochs)), epochs  # rose at each step

        # the watcher announces; the rejoined peer's monitor sees it, acks
        whb.announce_shutdown(0, 2, grace_sec=0.2)
        assert not dmon.shutdown_seen
        dmon._tick()
        assert dmon.shutdown_seen
        assert wcl.get("bf.shutdown.ack.1") == 1
        # and the other way: the peer's own flag reaches the watcher
        assert not wmon.shutdown_seen
        dhb.announce_shutdown(1, 2, grace_sec=0.2)
        wmon._tick()
        assert wmon.shutdown_seen
    finally:
        for c in (wcl, dcl, dcl1):
            if c is not None:
                c.close()
        server.stop()
