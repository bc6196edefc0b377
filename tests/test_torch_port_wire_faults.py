"""The port's control plane under injected faults: the window-free cases of
``tests/test_chaos.py``, on the port's binding and shard servers.

* the fault layer is off by default; ``fetch_add`` stays exactly-once
  under connection drops, alone and batched, and the drops are metered
  (redials, server dedup replays, and the registry snapshot's
  ``cp.fault.*``/``cp.client.*`` counters with a control plane attached);
* a server-side connection drop reconnects transparently;
  ``BFT_CP_RETRIES=0`` fails fast, and a stray ``BLUEFOG_CP_RETRIES=0``
  without its ``BFT_*`` twin leaves reconnection on (the library reads
  the port's value, never the JAX package's);
* a dead lock holder and lease expiry (``BFT_CP_LOCK_LEASE``) wake the
  waiter with a typed ``PeerLostError``, and a barrier's deadline
  (``BFT_CP_BARRIER_TIMEOUT``) is bounded;
* incarnation fencing: a zombie gets typed ``StaleIncarnationError`` on
  every op class, also under drops, and a stale attach is refused;
* ``runtime/shard_server.py`` processes started by file path (one with
  ``torch`` made unimportable): failover keeps ``fetch_add``
  exactly-once, deposits drained across a SIGKILL conserve their bytes,
  the replicated membership keys survive the kill, a fresh attach with a
  down, unflagged shard is refused, and with WAL replication a counter
  continues across the kill.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from bluefog_tpu_torch.runtime import control_plane as cp
from bluefog_tpu_torch.runtime import metrics, native
from bluefog_tpu_torch.runtime.config import knob_env
from bluefog_tpu_torch.runtime.router import ShardRouter

SHARD_SERVER = (Path(__file__).resolve().parent.parent / "bluefog_tpu_torch"
                / "runtime" / "shard_server.py")


@pytest.fixture(autouse=True)
def _fault_disarmed():
    """Every test starts and ends with injection off (process-global)."""
    native.fault_disarm()
    yield
    native.fault_disarm()


@pytest.fixture()
def server():
    srv = native.ControlPlaneServer(2, 0)
    yield srv
    native.fault_disarm()  # a delay knob must never wedge teardown
    srv.stop()


def _client(port, rank=0, **kw):
    kw.setdefault("streams", 1)
    return native.ControlPlaneClient("127.0.0.1", port, rank, **kw)


def test_fault_layer_off_by_default(server):
    assert "BFT_CP_FAULT" not in os.environ
    cl = _client(server.port)
    for i in range(20):
        cl.put(f"off.{i}", i)
    assert cl.get("off.7") == 7
    assert native.fault_stats() == {"ops": 0, "drops": 0}
    cl.close()


def test_fetch_add_exactly_once_under_drops(server):
    cl = _client(server.port)
    native.fault_arm("drop_after=4,seed=1")
    seen = [cl.fetch_add("ctr", 1) for _ in range(40)]
    drops = native.fault_stats()["drops"]
    native.fault_disarm()
    assert drops >= 3, f"only {drops} drops injected"
    assert seen == list(range(40))  # no add lost, none applied twice
    assert cl.get("ctr") == 40
    cl.close()


def test_batched_fetch_add_exactly_once_under_drops(server):
    cl = _client(server.port)
    native.fault_arm("drop_after=3,seed=0,trunc=1")
    total = 0
    for _ in range(12):
        pre = cl.fetch_add_many(["a", "b", "c"], deltas=[1, 2, 3])
        assert pre == [total, 2 * total, 3 * total], (pre, total)
        total += 1
    drops = native.fault_stats()["drops"]
    native.fault_disarm()
    assert drops >= 3
    assert cl.get_many(["a", "b", "c"]) == [12, 24, 36]
    cl.close()


def test_fault_metrics_match_injected_drops(server, monkeypatch):
    """Every injected drop shows up as a client redial, the reply-lost half
    as server dedup replays, and a snapshot taken with the control plane
    attached carries the injector's and the transport's counters."""
    for k, v in {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(server.port),
                 "BFT_CP_WORLD": "1", "BFT_CP_SERVE": "0"}.items():
        monkeypatch.setenv(k, v)
    cp.detach()
    assert cp.attach() is not None
    try:
        metrics.reset_for_job()
        base = native.client_stats()
        cl = _client(server.port)
        native.fault_arm("drop_after=4,seed=13")
        for _ in range(40):
            cl.fetch_add("fm.ctr", 1)
        drops = native.fault_stats()["drops"]
        snap = metrics.snapshot()
        native.fault_disarm()
        assert drops >= 5, f"only {drops} drops injected"
        assert cl.get("fm.ctr") == 40
        redials = native.client_stats()["redials"] - base["redials"]
        assert redials >= drops, (redials, drops)
        assert server.stats()["dedup_replays"] >= 1
        assert snap["counters"]["cp.fault.drops"] == drops
        assert snap["counters"]["cp.fault.ops"] > 0
        assert snap["counters"]["cp.client.redials"] >= drops
        assert snap["counters"]["cp.client.ops.fetch_add"] >= 40
        assert "cp.client.ops.fetch_add" not in \
            metrics.snapshot(include_native=False)["counters"]
        cl.close()
    finally:
        cp.detach()
    assert "cp.fault.ops" not in metrics.snapshot()["counters"]


def test_server_drop_conns_hook_reconnects(server):
    cl = _client(server.port)
    cl.put("pre.kill", 1)
    server.drop_connections()
    time.sleep(0.05)
    cl.put("post.kill", 2)  # transparent reconnect
    assert cl.get("pre.kill") == 1 and cl.get("post.kill") == 2
    cl.close()


def test_retries_zero_disables_reconnect(server, monkeypatch):
    monkeypatch.setenv("BFT_CP_RETRIES", "0")
    cl = _client(server.port)
    cl.put("x", 1)
    server.drop_connections()
    time.sleep(0.05)
    with pytest.raises(OSError):
        cl.put("x", 2)
    cl.close()


def test_stray_jax_knob_does_not_reach_the_library(server, monkeypatch):
    """``BLUEFOG_CP_RETRIES=0`` is the JAX package's knob: with no
    ``BFT_CP_RETRIES`` the port's client keeps its 3 retries, and the
    JAX name is back in the environment after the call."""
    monkeypatch.setenv("BLUEFOG_CP_RETRIES", "0")
    monkeypatch.delenv("BFT_CP_RETRIES", raising=False)
    cl = _client(server.port)
    assert os.environ["BLUEFOG_CP_RETRIES"] == "0"
    cl.put("x", 1)
    server.drop_connections()
    time.sleep(0.05)
    cl.put("x", 2)  # reconnected
    assert cl.get("x") == 2
    cl.close()


def test_lock_dead_holder_wakes_waiter_typed(server):
    holder = _client(server.port, 1)
    waiter = _client(server.port, 0)
    holder.lock("L")
    result = {}

    def wait_for_lock():
        try:
            waiter.lock("L")
            result["outcome"] = "granted"
        except native.PeerLostError as exc:
            result["outcome"] = "peerlost"
            result["msg"] = str(exc)
            result["dead"] = exc.dead

    t = threading.Thread(target=wait_for_lock, daemon=True)
    t.start()
    time.sleep(0.4)
    assert "outcome" not in result, "the waiter got the lock past a holder"
    holder.close()  # the connection closes while holding: force release
    t.join(10.0)
    assert not t.is_alive()
    assert result.get("outcome") == "peerlost", result
    assert "force-released" in result["msg"]
    assert result["dead"] == set()  # no heartbeat monitor in the port yet
    waiter.lock("L")  # the lock was left free
    waiter.unlock("L")
    waiter.close()


def test_lock_lease_expiry_and_broken_unlock(monkeypatch):
    monkeypatch.setenv("BFT_CP_LOCK_LEASE", "0.4")
    srv = native.ControlPlaneServer(2, 0)
    try:
        holder = _client(srv.port, 1)
        waiter = _client(srv.port, 0)
        holder.lock("M")
        t0 = time.monotonic()
        with pytest.raises(native.PeerLostError, match="force-released"):
            waiter.lock("M")
        assert time.monotonic() - t0 < 5.0  # bounded by the lease
        waiter.lock("M")
        waiter.unlock("M")
        with pytest.raises(native.PeerLostError, match="critical section"):
            holder.unlock("M")
        holder.close()
        waiter.close()
    finally:
        srv.stop()


def test_barrier_deadline_is_bounded(monkeypatch):
    monkeypatch.setenv("BFT_CP_BARRIER_TIMEOUT", "0.5")
    srv = native.ControlPlaneServer(2, 0)
    try:
        cl = _client(srv.port, 0)
        t0 = time.monotonic()
        with pytest.raises(native.PeerLostError, match="never arrived"):
            cl.barrier("lonely")
        assert time.monotonic() - t0 < 5.0
        # the timed-out arrival was withdrawn: a later full barrier works
        other = _client(srv.port, 1)
        done = []
        t = threading.Thread(target=lambda: done.append(cl.barrier("b2")),
                             daemon=True)
        t.start()
        other.barrier("b2")
        t.join(5.0)
        assert done, "the paired barrier did not complete"
        cl.close()
        other.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("streams", [4, 1])
def test_zombie_gets_typed_stale_rejections(streams):
    srv = native.ControlPlaneServer(2, 0)
    try:
        old = _client(srv.port, 1, streams=streams, incarnation=0)
        old.fetch_add("z.ctr", 1)                       # a dedup entry
        old.append_bytes_tagged_many(
            ["z.box"], [b"stale-parameters"],
            [(((1 & 0x7F) << 32) | 7) << 24])           # origin-tagged
        old.lock("z.lock")                               # a held lock
        assert srv.incarnation_of(1) == 0
        assert srv.mailbox_records_from(1) == 1
        assert srv.dedup_entries() >= 1
        new = _client(srv.port, 1, streams=streams, incarnation=1)
        assert srv.incarnation_of(1) == 1
        assert srv.mailbox_records_from(1) == 0
        assert srv.dedup_entries() == 0
        new.lock("z.lock")  # force-released from the zombie
        new.unlock("z.lock")
        zombie_ops = [
            lambda: old.put("z.x", 1),
            lambda: old.get("z.x"),
            lambda: old.fetch_add("z.ctr", 1),
            lambda: old.barrier("z.bar"),
            lambda: old.lock("z.lock2"),
            lambda: old.unlock("z.lock"),
            lambda: old.append_bytes("z.box", b"more"),
            lambda: old.take_bytes("z.box"),
            lambda: old.put_bytes("z.blob", b"payload"),
            lambda: old.get_bytes("z.blob"),
            lambda: old.get_many(["z.x", "z.y"]),
            lambda: old.put_many(["z.x"], [2]),
            lambda: old.fetch_add_many(["z.c2"]),
            lambda: old.box_bytes_many(["z.box"]),
            lambda: old.take_bytes_many(["z.box"]),
            lambda: old.get_bytes_many(["z.blob"]),
            lambda: old.append_bytes_many(["z.box"], [b"r"]),
            lambda: old.bytes_len("z.blob"),
        ]
        for op in zombie_ops:
            with pytest.raises(native.StaleIncarnationError,
                               match="superseded"):
                op()
        new.put("z.alive", 5)
        assert new.get("z.alive") == 5
        old.close()
        new.close()
    finally:
        srv.stop()


def test_stale_attach_rejected_at_connect():
    srv = native.ControlPlaneServer(2, 0)
    try:
        fresh = _client(srv.port, 0, incarnation=3)
        with pytest.raises(native.StaleIncarnationError):
            _client(srv.port, 0, incarnation=2)
        peer = _client(srv.port, 0, incarnation=3)  # equal is not stale
        peer.put("ok", 1)
        peer.close()
        fresh.close()
    finally:
        srv.stop()


def test_zombie_fenced_while_transport_drops():
    srv = native.ControlPlaneServer(2, 0)
    try:
        old = _client(srv.port, 1, incarnation=0)
        old.put("f.pre", 1)
        new = _client(srv.port, 1, incarnation=1)
        native.fault_arm("drop_after=4,seed=11")
        seen = [new.fetch_add("f.ctr", 1) for _ in range(30)]
        for _ in range(10):
            with pytest.raises(native.StaleIncarnationError):
                old.fetch_add("f.ctr", 1)
            with pytest.raises(native.StaleIncarnationError):
                old.put("f.pre", 2)
        drops = native.fault_stats()["drops"]
        native.fault_disarm()
        assert drops >= 3, f"only {drops} drops injected"
        assert seen == list(range(30))
        assert new.get("f.ctr") == 30
        assert new.get("f.pre") == 1, "a zombie write leaked through"
        old.close()
        new.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# shard server processes
# ---------------------------------------------------------------------------

def _readline(proc, timeout: float = 60.0) -> str:
    """The child's next stdout line, or AssertionError after ``timeout``
    seconds (a shard that never reports must not hang the suite)."""
    out = []
    t = threading.Thread(target=lambda: out.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout)
    assert out, f"no line from the shard server within {timeout} s"
    return out[0]


def _spawn_shard(i: int, env=None, expect_peers: bool = False):
    """Start ``shard_server.py`` by file path; returns (proc, port) after
    its first line (``BF_SHARD_READY``, or ``BF_SHARD_PORT`` with
    ``expect_peers``)."""
    cmd = [sys.executable, str(SHARD_SERVER), "--port", "0", "--world", "1",
           "--shard", str(i)] + (["--expect-peers"] if expect_peers else [])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stdin=subprocess.PIPE, text=True, env=env)
    want = "BF_SHARD_PORT" if expect_peers else "BF_SHARD_READY"
    try:
        line = _readline(proc)
        assert line.startswith(want), f"shard {i}: {line!r}"
    except AssertionError:
        proc.kill()
        proc.wait()
        raise
    return proc, int(line.split()[1])


def _stop_shards(servers):
    for proc, _ in servers:
        if proc.poll() is None:
            proc.terminate()
    for proc, _ in servers:
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stdin.close()


def _kill(servers, i: int) -> None:
    proc, _ = servers[i]
    proc.send_signal(signal.SIGKILL)
    proc.wait()


def _eps(servers):
    return [("127.0.0.1", port) for _, port in servers]


@pytest.fixture()
def shard_pair(monkeypatch):
    """Two shard server PROCESSES (SIGKILL-able), fast reconnects."""
    native.load()  # built once here, not by both children at once
    monkeypatch.setenv("BFT_CP_BACKOFF_MS", "20")
    servers = [_spawn_shard(i) for i in range(2)]
    yield servers
    native.fault_disarm()
    _stop_shards(servers)


def test_shard_server_starts_without_torch(tmp_path):
    """Run by file path, the shard server imports neither the package's
    ``__init__`` nor torch: with a ``torch`` whose import raises first on
    the path it still serves."""
    native.load()
    poison = tmp_path / "torch"
    poison.mkdir()
    (poison / "__init__.py").write_text(
        "raise ImportError('torch must not be imported here')\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    servers = [_spawn_shard(0, env=env)]
    try:
        cl = _client(servers[0][1], 3)
        # the server published its own mailbox cap
        cap = int(knob_env("BFT_CP_MAILBOX_MAX_MB") * (1 << 20))
        assert cl.get("bf.cp.mailbox_cap_bytes") == cap + 1
        cl.close()
    finally:
        _stop_shards(servers)
    assert servers[0][0].returncode == 0


def test_shard_failover_fetch_add_exactly_once(shard_pair):
    """Before the kill the victim's counter hands out contiguous values
    under drops; after it the key reroutes to the survivor, where the era
    restarts at 0 and stays contiguous."""
    r = ShardRouter(_eps(shard_pair), 0, streams=1)
    key = next(f"fo.ctr.{j}" for j in range(64)
               if r.shard_of(f"fo.ctr.{j}") == 1)
    native.fault_arm("drop_after=6,seed=23")
    pre = [r.fetch_add(key, 1) for _ in range(25)]
    assert pre == list(range(25))
    _kill(shard_pair, 1)
    post = [r.fetch_add(key, 1) for _ in range(25)]
    drops = native.fault_stats()["drops"]
    native.fault_disarm()
    assert drops >= 3, f"only {drops} drops injected"
    assert r.dead_shards() == {1}
    assert post == list(range(25))
    assert r.get(key) == 25
    r.close()


def test_shard_mailbox_failover_mass_conserved(shard_pair):
    r = ShardRouter(_eps(shard_pair), 0, streams=1)
    rng = np.random.default_rng(29)
    boxes = [f"mb.{k}" for k in range(6)]
    assert {r.shard_of(b) for b in boxes} == {0, 1}
    acked = drained = 0

    def cycle():
        nonlocal acked, drained
        names, blobs = [], []
        for b in boxes:
            for _ in range(2):
                names.append(b)
                blobs.append(bytes(rng.integers(
                    0, 256, size=int(rng.integers(64, 2048)),
                    dtype=np.uint8)))
        replies = r.append_bytes_many(names, blobs)
        acked += sum(len(b) for b, rep in zip(blobs, replies) if rep >= 1)
        drained += sum(len(x) for lst in r.take_bytes_many(boxes)
                       for x in lst)

    for _ in range(3):
        cycle()
    _kill(shard_pair, 1)
    for _ in range(3):
        cycle()
    assert r.dead_shards() == {1}
    assert acked == drained
    r.close()


def test_shard_replicated_membership_state_survives_kill(shard_pair):
    eps = _eps(shard_pair)
    fresh = ShardRouter(eps, 7, streams=1, incarnation=1)
    r = ShardRouter(eps, 0, streams=1)
    r.put("bf.q.7.1", 1)
    r.put("bf.q.7.1", 2)
    e0 = r.get("bf.membership.epoch")
    e1 = r.fetch_add("bf.membership.epoch", 1)
    assert e1 >= e0
    _kill(shard_pair, 1)
    assert r.get("bf.q.7.1") == 2
    assert r.get("bf.membership.epoch") >= e1 + 1
    with pytest.raises(native.StaleIncarnationError):
        ShardRouter(eps, 7, streams=1, incarnation=0)
    fresh.close()
    r.close()


def test_shard_attach_strictness_vs_flagged_death(shard_pair):
    eps = _eps(shard_pair)
    _kill(shard_pair, 1)
    with pytest.raises(OSError, match="not flagged dead"):
        ShardRouter(eps, 0, streams=1)
    cl = _client(shard_pair[0][1], 9)
    cl.put_max("bf.cp.shard_dead.1", 1)
    cl.close()
    r = ShardRouter(eps, 0, streams=1)
    assert r.dead_shards() == {1}
    r.put("deg.x", 5)
    assert r.get("deg.x") == 5
    r.close()


def test_repl_fetch_add_continuous_across_kill(monkeypatch):
    """Two shard servers wired as a replicated ring (``--expect-peers``,
    the default ``BFT_CP_REPLICATION=1``): the counter of a key owned by
    the killed shard continues on its successor, with no value skipped or
    repeated, and a replicated ``put_max`` key survives."""
    native.load()
    monkeypatch.setenv("BFT_CP_BACKOFF_MS", "20")
    servers = [_spawn_shard(i, expect_peers=True) for i in range(2)]
    try:
        ring = ",".join(f"127.0.0.1:{port}" for _, port in servers)
        for proc, _ in servers:
            proc.stdin.write(f"BF_SHARD_PEERS {ring}\n")
            proc.stdin.flush()
        for i, (proc, _) in enumerate(servers):
            line = _readline(proc)
            assert line.startswith("BF_SHARD_READY"), f"shard {i}: {line!r}"
        r = ShardRouter(_eps(servers), 0, streams=1)
        key = next(f"cc.ctr.{j}" for j in range(64)
                   if r.shard_of(f"cc.ctr.{j}") == 1)
        r.put_max("bf.cp.test.max", 41)
        native.fault_arm("drop_after=6,seed=43")
        pre = [r.fetch_add(key, 1) for _ in range(25)]
        _kill(servers, 1)
        post = [r.fetch_add(key, 1) for _ in range(25)]
        native.fault_disarm()
        assert pre + post == list(range(50))
        assert r.get(key) == 50
        assert r.get("bf.cp.test.max") == 41
        assert r.dead_shards() == {1}
        r.close()
    finally:
        _stop_shards(servers)
