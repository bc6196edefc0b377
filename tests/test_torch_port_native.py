"""Port vs JAX: the native control plane's binding (``runtime/native.py``).

* the counterparts of ``tests/test_native.py``'s eight tests on the port's
  binding: the native timeline writer, fetch-and-add and the KV, barrier
  and mutex, a blocked second holder, bulk bytes with the bounded take,
  tagged appends, the zero-copy drain, and a 50,000-record batch that
  must not deadlock;
* the op table (``runtime/protocol.py``) equal to JAX's, row for row;
* ``parse_fault_spec``, the partition grammar and the edge-delay grammar
  equal to JAX's on the specs ``tests/test_chaos.py`` uses, errors
  included;
* wire compatibility: a JAX server with a port client and a JAX client on
  it, and a port server with both, scalars and bytes crossing both ways,
  equal byte for byte.

The port builds the library from ``csrc/bf_runtime.cc`` into its own
``_build/`` directory, so the two packages load two copies of it in this
process; they meet only over TCP.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest

from bluefog_tpu.runtime import native as jnative
from bluefog_tpu.runtime import protocol as jprotocol
from bluefog_tpu_torch.runtime import native, protocol
from bluefog_tpu_torch.runtime.timeline import Timeline


def test_native_timeline_roundtrip(tmp_path):
    prefix = str(tmp_path / "tl")
    tl = Timeline(prefix, process_index=0, use_native=True)
    assert tl._native is not None, "the native writer should be active"
    tl.activity_start("tensor.a", "NEIGHBOR_ALLREDUCE")
    tl.activity_end("tensor.a")
    tl.activity_start("tensor.b", "WIN_PUT", tid=3)
    tl.activity_end("tensor.b", tid=3)
    tl.counter("mailbox.depth", 7)
    tl.close()
    events = json.load(open(prefix + "0.json"))
    assert events[0]["name"] == "bf.clock_sync_us"
    assert events[0]["ph"] == "C"
    names = [e.get("name") for e in events]
    assert "NEIGHBOR_ALLREDUCE" in names and "WIN_PUT" in names
    phases = [e["ph"] for e in events]
    assert phases.count("B") == 2 and phases.count("E") == 2
    b = next(e for e in events if e.get("name") == "WIN_PUT")
    assert b["tid"] == 3 and b["cat"] == "tensor.b"
    c = next(e for e in events if e.get("name") == "mailbox.depth")
    assert c["args"]["value"] == 7


def test_control_plane_fetch_add_and_kv():
    with native.ControlPlaneServer(world=2) as srv:
        with native.ControlPlaneClient("127.0.0.1", srv.port, rank=0) as c:
            assert c.fetch_add("ver.x", 1) == 0
            assert c.fetch_add("ver.x", 5) == 1
            assert c.get("ver.x") == 6
            c.put("p.3", 42)
            assert c.get("p.3") == 42
            assert c.get("missing") == 0


def test_control_plane_barrier_and_mutex():
    with native.ControlPlaneServer(world=3) as srv:
        clients = [native.ControlPlaneClient("127.0.0.1", srv.port, rank=r)
                   for r in range(3)]
        order = []
        times = {}

        def worker(r):
            clients[r].barrier("start")
            times[r] = time.monotonic()
            clients[r].lock("m")
            order.append(r)
            time.sleep(0.02)
            clients[r].unlock("m")

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(3)]
        threads[0].start()
        time.sleep(0.1)  # the barrier must hold rank 0 until all arrive
        assert 0 not in times
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        assert sorted(order) == [0, 1, 2]  # the mutex serialized all three
        assert max(times.values()) - min(times.values()) < 0.5
        for c in clients:
            c.close()


def test_mutex_blocks_second_holder():
    with native.ControlPlaneServer(world=2) as srv:
        c0 = native.ControlPlaneClient("127.0.0.1", srv.port, rank=0)
        c1 = native.ControlPlaneClient("127.0.0.1", srv.port, rank=1)
        c0.lock("w")
        acquired = []

        def try_lock():
            c1.lock("w")
            acquired.append(time.monotonic())
            c1.unlock("w")

        t = threading.Thread(target=try_lock)
        t0 = time.monotonic()
        t.start()
        time.sleep(0.15)
        assert not acquired, "rank 1 must block while rank 0 holds the lock"
        c0.unlock("w")
        t.join(timeout=10)
        assert not t.is_alive()
        assert acquired and acquired[0] - t0 >= 0.1
        c0.close()
        c1.close()


def test_bulk_bytes_roundtrip_and_bounded_take():
    """Record framing of append/take, put/get slots, and the bounded take
    reply: a backlog over 64 MiB drains over several takes, in order."""
    with native.ControlPlaneServer(world=1, port=0) as srv:
        cl = native.ControlPlaneClient("127.0.0.1", srv.port, rank=0)
        cl.append_bytes("box", b"a")
        cl.append_bytes("box", b"bb" * 500)
        assert cl.take_bytes("box") == [b"a", b"bb" * 500]
        assert cl.take_bytes("box") == []
        cl.put_bytes("slot", b"\x07" * 4096)
        assert cl.get_bytes("slot") == b"\x07" * 4096
        assert cl.get_bytes("never") == b""
        big = [bytes([i]) * (30 << 20) for i in range(3)]
        for b in big:
            cl.append_bytes("deep", b)
        drained, takes = [], 0
        while True:
            recs = cl.take_bytes("deep")
            if not recs:
                break
            takes += 1
            drained.extend(recs)
        assert takes >= 2, "an oversized backlog must need several takes"
        assert [r[:1] for r in drained] == [b"\x00", b"\x01", b"\x02"]
        assert [len(r) for r in drained] == [30 << 20] * 3
        cl.put_many(["k.0", "k.1", "k.2"], [10, 11, 12])
        assert cl.get_many(["k.2", "k.0", "k.1"]) == [12, 10, 11]
        # oversized payloads are refused before the wire, connection intact
        with pytest.raises(ValueError):
            cl.append_bytes("box", b"\x00" * (1 << 30))
        assert cl.get("k.0") == 10
        cl.close()


def test_append_bytes_tagged_prefixes_records():
    with native.ControlPlaneServer(world=1, port=0) as srv:
        cl = native.ControlPlaneClient("127.0.0.1", srv.port, rank=0)
        tags = [(5 << 24) | 0, (5 << 24) | 1]
        cl.append_bytes_tagged_many(["tg", "tg"], [b"head", b"cont"], tags)
        recs = cl.take_bytes("tg")
        assert [int.from_bytes(r[:8], "little") for r in recs] == tags
        assert [r[8:] for r in recs] == [b"head", b"cont"]
        cl.close()


def test_take_bytes_many_views_zero_copy_drain():
    with native.ControlPlaneServer(world=1, port=0) as srv:
        cl = native.ControlPlaneClient("127.0.0.1", srv.port, rank=0)
        cl.append_bytes("v.0", b"aa")
        cl.append_bytes("v.0", b"b" * 4096)
        cl.append_bytes("v.2", b"ccc")
        batches, owner = cl.take_bytes_many_views(["v.0", "v.1", "v.2"])
        try:
            assert [bytes(r) for r in batches[0]] == [b"aa", b"b" * 4096]
            assert batches[1] == []
            assert [bytes(r) for r in batches[2]] == [b"ccc"]
            assert all(isinstance(r, memoryview)
                       for recs in batches for r in recs)
        finally:
            owner.close()
        assert len(owner.view) == 0  # close() invalidates the view
        cl.close()


def test_bounded_inflight_multi_out_no_deadlock():
    """50,000 records in one bytes batch: the client bounds its unread
    replies, so neither side parks in a write the other never drains."""
    n = 50_000
    with native.ControlPlaneServer(world=1, port=0) as srv:
        cl = native.ControlPlaneClient("127.0.0.1", srv.port, rank=0)
        names = [f"dl.{i % 7}" for i in range(n)]
        blobs = [b"x" * 16] * n
        done = []
        t = threading.Thread(
            target=lambda: done.append(cl.append_bytes_many(names, blobs)),
            daemon=True)
        t.start()
        t.join(timeout=120)
        assert done, "bytes batch deadlocked"
        assert len(done[0]) == n and all(r >= 1 for r in done[0])
        total = 0
        for k in range(7):
            while True:
                recs = cl.take_bytes(f"dl.{k}")
                if not recs:
                    break
                total += len(recs)
        assert total == n
        cl.close()


def test_op_table_equals_jax():
    assert [dataclasses.astuple(o) for o in protocol.OPS] == \
        [dataclasses.astuple(o) for o in jprotocol.OPS]
    assert protocol.OP_CODES == jprotocol.OP_CODES
    assert protocol.OP_NAMES == jprotocol.OP_NAMES
    assert protocol.RETRY_UNSAFE == jprotocol.RETRY_UNSAFE
    assert dataclasses.astuple(protocol.spec("put_max")) == \
        dataclasses.astuple(jprotocol.spec("put_max"))
    for mod in (protocol, jprotocol):
        with pytest.raises(KeyError):
            mod.spec("no_such_op")


# the specs of tests/test_chaos.py's grammar tests, good and bad
FAULT_SPECS = [
    "drop_after=37,delay_ms=50,trunc=1,seed=7", "drop_after=5", "",
    "drop_every=5", "drop_after",
    "partition=0,1|2,3", "partition=0,1,2|3,heal_after=2.5,part_after=1",
    "drop_after=4,partition=0|1,seed=9", "partition=0,1",
    "partition=0,1|1,2", "partition=a|b", "heal_after=2.5",
    "delay_edges=0>1:80", "delay_edges=0>1:80;2>3:40",
    "delay_edges=0>1:80|2>3:40", "delay_edges=0>1:80,2>3:40",
    "drop_after=9,delay_edges=1>0:25,seed=3", "delay_edges=0-1:80",
    "delay_edges=0>1", "delay_edges=x>y:5",
]


def _parse(mod, fn, text):
    try:
        return ("ok", fn(mod)(text))
    except ValueError:
        return ("ValueError", None)


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_spec_parsing_equals_jax(spec):
    j = _parse(jnative, lambda m: m.parse_fault_spec, spec)
    p = _parse(native, lambda m: m.parse_fault_spec, spec)
    assert p == j


@pytest.mark.parametrize("text", ["0,1|2,3", "0|1|2", " 3 , 1 | 0 ",
                                  "0,1", "0,1|1,2", "a|b", ""])
def test_partition_groups_equal_jax(text):
    assert _parse(native, lambda m: m.parse_partition_groups, text) == \
        _parse(jnative, lambda m: m.parse_partition_groups, text)


@pytest.mark.parametrize("text", ["0>1:80", "0>1:80;2>3:40",
                                  "0>1:80|2>3:40", " 1>0:25 ; ", "0-1:80",
                                  "0>1", "x>y:5"])
def test_edge_delay_parsing_equals_jax(text):
    assert _parse(native, lambda m: m._parse_edge_delays, text) == \
        _parse(jnative, lambda m: m._parse_edge_delays, text)


_SIDES = {"jax": jnative, "port": native}


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_wire_compatible_both_ways(server_side):
    """One server, a port client and a JAX client on it: every scalar and
    byte one writes, the other reads back equal, both directions, and
    the counters and mailboxes interleave as one."""
    srv = _SIDES[server_side].ControlPlaneServer(2, 0, secret="s3")
    try:
        p = native.ControlPlaneClient("127.0.0.1", srv.port, 0,
                                      secret="s3", streams=1)
        j = jnative.ControlPlaneClient("127.0.0.1", srv.port, 1,
                                       secret="s3", streams=1)
        rng = np.random.default_rng(11)
        blobs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                 for n in (0, 1, 4093, 70_000)]
        for writer, reader, tag in ((p, j, "p2j"), (j, p, "j2p")):
            writer.put(f"{tag}.scalar", -123456789012)
            assert reader.get(f"{tag}.scalar") == -123456789012
            writer.put_many([f"{tag}.m.{i}" for i in range(5)],
                            list(range(-2, 3)))
            assert reader.get_many([f"{tag}.m.{i}" for i in range(5)]) == \
                list(range(-2, 3))
            for i, b in enumerate(blobs):
                writer.put_bytes(f"{tag}.b.{i}", b)
                assert reader.get_bytes(f"{tag}.b.{i}") == b
            writer.append_bytes_many([f"{tag}.box"] * len(blobs), blobs)
            assert reader.take_bytes(f"{tag}.box") == blobs
            assert writer.put_max(f"{tag}.max", 9) == 9
            assert reader.put_max(f"{tag}.max", 4) == 9
        seen = [c.fetch_add("shared.ctr", 1) for c in (p, j, p, j)]
        assert seen == [0, 1, 2, 3]
        assert p.get("shared.ctr") == j.get("shared.ctr") == 4
        # a barrier of world 2 completes with one client of each package
        done = []
        t = threading.Thread(target=lambda: done.append(j.barrier("mixed")),
                             daemon=True)
        t.start()
        p.barrier("mixed")
        t.join(10.0)
        assert done == [1]
        # the server's counters, read over the wire by either client (each
        # read counts itself under "stats")
        sp, sj = p.server_stats(), j.server_stats()
        assert sj["ops"].pop("stats") == sp["ops"].pop("stats") + 1
        assert sp == sj
        p.close()
        j.close()
    finally:
        srv.stop()
