"""Port vs JAX: the serve client, its request tracing and SLO recording.

``bluefog_tpu_torch/serving/client.py`` and the serve attribution of
``runtime/flight.py``, held to ``bluefog_tpu/serving/client.py`` and
``bluefog_tpu/runtime/flight.py`` on the CPU (``device="cpu"``):

* a JAX and a port client on one control-plane server: the hot swap of
  ``tests/test_serving.py:267`` (``xs + params[0][0]`` in numpy and in
  torch) gives equal answers bit for bit and equal ``version()``,
  ``swaps`` and ``requests``; the admission gate of ``:294`` sheds the same
  count through the same gate;
* interop both ways: a JAX publisher to a port client and a port publisher
  to a JAX client, the leaves (a bf16 one included) and answers exact;
* ``analyze_serve``, ``serve_report`` and ``format_serve_report`` equal to
  JAX's on one document (``tests/test_slo.py:230``, ``:268``, and a live
  traced port client's ring); the SLO burn rates of ``test_slo.py:130-228``
  equal on the port's and JAX's stores, and a client's published SLO
  series read by JAX's reader;
* the traced end-to-end run of ``test_slo.py:396`` against a port
  publisher child: one merged trace with a cross-process flow pair, phase
  buckets summing to the latency, lineage naming the producing step;
* a traced failover across a shard SIGKILL and rejoin
  (``tests/test_chaos.py:1916``) on the port's shard servers;
* the slice as a whole: a small f32 ``TransformerLM`` carried from flax
  with ``params_from_jax``, published by the port, served by the port's
  client (plain K1) as last-position logits within 1e-4 of the largest
  logit of JAX's ``model.apply``, then a perturbed second version swapped
  in;
* a world-4 gloo train-while-serve run: ``DistributedPushSumOptimizer``
  under a control plane, publishing every step, the port's and JAX's
  clients serving each version with rank 0's parameters bit for bit.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import ml_dtypes

from bluefog_tpu.runtime import flight as jflight
from bluefog_tpu.runtime import native as jnative
from bluefog_tpu.runtime import timeseries as jts
from bluefog_tpu.serving import snapshot as jsnap
from bluefog_tpu.serving.client import RequestShed as JRequestShed
from bluefog_tpu.serving.client import ServeClient as JServeClient
from bluefog_tpu_torch.runtime import flight, metrics, native
from bluefog_tpu_torch.runtime import timeseries as ts
from bluefog_tpu_torch.serving import (RequestShed, ServeClient,
                                       serve_client)
from bluefog_tpu_torch.serving import snapshot as snap

from _torch_port_serve_child import STEPS, collect, spawn

TESTS = Path(__file__).resolve().parent
PUB_CHILD = TESTS / "_torch_port_serve_pub_child.py"
SHARD_SERVER = TESTS.parent / "bluefog_tpu_torch" / "runtime" / \
    "shard_server.py"
WAIT_S = 20.0


def _until(cond, what: str, limit: float = WAIT_S) -> None:
    deadline = time.monotonic() + limit
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} within {limit} s")
        time.sleep(0.02)


@pytest.fixture()
def knobs(monkeypatch):
    """Set a serve knob in both packages (``BFT_*`` and ``BLUEFOG_*``)."""
    def set_(name: str, value: str) -> None:
        monkeypatch.setenv("BFT_" + name, value)
        monkeypatch.setenv("BLUEFOG_" + name, value)
    set_("SERVE_POLL_S", "0.05")
    return set_


@pytest.fixture()
def server():
    with native.ControlPlaneServer(world=2) as srv:
        yield srv


def _add_first(params, xs):
    return xs + params[0][0]


# ---------------------------------------------------------------------------
# one server, both packages' clients
# ---------------------------------------------------------------------------

def test_hot_swap_matches_jax_client(knobs, server):
    eps = [("127.0.0.1", server.port)]
    pcl = native.ControlPlaneClient("127.0.0.1", server.port, rank=0)
    pub = snap.SnapshotPublisher(pcl, shards=3)
    pub.publish([np.full(200, 1.0, np.float32)], 1)
    pc = ServeClient(eps, _add_first, device="cpu")
    jc = JServeClient(eps, model_fn=_add_first)
    try:
        assert pc.wait_ready(WAIT_S) and jc.wait_ready(WAIT_S)
        x = np.linspace(-1, 1, 3).astype(np.float32)
        outs = [(pc.infer(x, WAIT_S), jc.infer(x, WAIT_S))]
        pub.publish([np.full(200, 5.0, np.float32)], 2)
        _until(lambda: pc.version() == 2 and jc.version() == 2,
               "both clients swapped to version 2")
        outs.append((pc.infer(x, WAIT_S), jc.infer(x, WAIT_S)))
        for (p, j), want in zip(outs, (1.0, 5.0)):
            assert p.dtype == j.dtype == np.float32
            np.testing.assert_array_equal(p, j)
            np.testing.assert_array_equal(p, x + np.float32(want))
        ps, js = pc.stats(), jc.stats()
        assert pc.version() == jc.version() == 2
        for key in ("swaps", "requests", "batches", "shed", "pulls"):
            assert ps[key] == js[key], key
        assert ps["swaps"] == 2 and ps["requests"] == 2
        assert isinstance(pc.params()[0], torch.Tensor)
        np.testing.assert_array_equal(pc.params()[0].numpy(), jc.params()[0])
    finally:
        pc.close()
        jc.close()
        pcl.close()


def _flood(client, shed_exc) -> tuple:
    """8 submissions 20 ms apart: (the gates that shed, the admitted
    futures with their inputs)."""
    gates, futs = [], []
    for i in range(8):
        x = np.full(2, i, np.float32)
        try:
            futs.append((x, client.submit(x)))
        except shed_exc as exc:
            gates.append(exc.gate)
        time.sleep(0.02)
    return gates, futs


def test_admission_gate_matches_jax(knobs, server):
    for name, value in (("SERVE_QUEUE_MAX", "2"), ("SERVE_QUEUE_SOFT", "1"),
                        ("SERVE_BATCH", "1")):
        knobs(name, value)
    eps = [("127.0.0.1", server.port)]
    pcl = native.ControlPlaneClient("127.0.0.1", server.port, rank=0)
    snap.SnapshotPublisher(pcl, shards=1).publish(
        [np.zeros(10, np.float32)], 1)
    release = threading.Event()

    def slow(params, xs):
        release.wait(30)
        return xs

    pc = ServeClient(eps, slow, device="cpu")
    jc = JServeClient(eps, model_fn=slow)
    try:
        assert pc.wait_ready(WAIT_S) and jc.wait_ready(WAIT_S)
        # one request parks in the batcher, two fill the queue, the rest
        # shed: never a hang, never a longer queue
        pg, pf = _flood(pc, RequestShed)
        jg, jf = _flood(jc, JRequestShed)
        assert pg == jg == ["queue_full"] * 5
        assert pc.stats()["shed"] == jc.stats()["shed"] == 5
        release.set()
        for futs in (pf, jf):
            for x, f in futs:
                np.testing.assert_array_equal(f.result(WAIT_S), x)
    finally:
        release.set()
        pc.close()
        jc.close()
        pcl.close()


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_interop_publisher_and_client_of_other_package(knobs, server,
                                                       publisher):
    """A JAX publisher to a port client, and a port publisher to a JAX
    client: the leaves exact (a bf16 leaf arrives as f32) and the answers
    of ``xs * params[0][:4] + params[1][0]`` exact."""
    eps = [("127.0.0.1", server.port)]
    rng = np.random.default_rng(15)
    versions = [[rng.standard_normal(33).astype(np.float32),
                 rng.standard_normal(5).astype(np.float32)]
                for _ in range(2)]
    if publisher == "jax":
        cl = jnative.ControlPlaneClient("127.0.0.1", server.port, rank=0)
        pub = jsnap.SnapshotPublisher(cl, shards=2)
        versions[1][1] = versions[1][1].astype(ml_dtypes.bfloat16)
        client = ServeClient(eps, lambda p, xs: xs * p[0][:4] + p[1][0],
                             device="cpu")
    else:
        cl = native.ControlPlaneClient("127.0.0.1", server.port, rank=0)
        pub = snap.SnapshotPublisher(cl, shards=2)
        client = JServeClient(eps,
                              model_fn=lambda p, xs: xs * p[0][:4] + p[1][0])
    x = np.arange(4, dtype=np.float32) - 1.5
    try:
        for ver, leaves in enumerate(versions, 1):
            pub.publish(leaves, ver)
            _until(lambda: client.version() == ver, f"version {ver}")
            got = [np.asarray(t) for t in client.params()]
            want = [np.asarray(a, np.float32) for a in leaves]
            for g, w in zip(got, want):
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(
                client.infer(x, WAIT_S), x * want[0][:4] + want[1][0])
    finally:
        client.close()
        cl.close()


def test_stress_swaps_under_concurrent_submitters(knobs, server):
    """More submitter threads than cores, a 10 us switch interval and a
    publisher bumping the version every 10 ms: every answer is one whole
    version (``x + v`` in every element), each thread's versions never go
    back, and no count is lost (``requests`` and ``accepted`` equal the
    answers)."""
    knobs("SERVE_BATCH", "4")
    n_threads = len(os.sched_getaffinity(0)) + 2
    pcl = native.ControlPlaneClient("127.0.0.1", server.port, rank=0)
    pub = snap.SnapshotPublisher(pcl, shards=2, keep=4)
    pub.publish([np.full(64, 1.0, np.float32)], 1)
    sc = ServeClient([("127.0.0.1", server.port)],
                     lambda p, xs: xs + p[0], device="cpu", poll_s=0.005)
    stop = threading.Event()
    seen = [[] for _ in range(n_threads)]
    errors = []

    def submitter(i):
        x = np.zeros(64, np.float32)
        try:
            while not stop.is_set():
                y = sc.infer(x, WAIT_S)
                assert (y == y[0]).all(), "a torn answer"
                seen[i].append(float(y[0]))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=submitter, args=(i,), daemon=True)
               for i in range(n_threads)]
    try:
        assert sc.wait_ready(WAIT_S)
        for t in threads:
            t.start()
        for ver in range(2, 40):
            pub.publish([np.full(64, float(ver), np.float32)], ver)
            time.sleep(0.01)
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(WAIT_S)
        sys.setswitchinterval(old)
        sc.close()
        pcl.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    answers = sum(len(v) for v in seen)
    assert answers > n_threads
    for vals in seen:
        assert vals == sorted(vals) and set(vals) <= set(range(1, 40))
    st = sc.stats()
    assert st["requests"] == st["accepted"] + st["queued"] == answers
    assert st["swaps"] >= 2


def test_pull_blobs_paces_and_matches_jax(knobs, server):
    """``pull_blobs`` returns the blobs ``get_bytes_many`` reads, in key
    order, in both packages; with the pacing hook a group of N bytes takes
    at least N / (pace MB/s)."""
    pcl = native.ControlPlaneClient("127.0.0.1", server.port, rank=0)
    pub = snap.SnapshotPublisher(pcl, shards=4)
    pub.publish([np.arange(500_000, dtype=np.float32)], 1)
    keys = snap.snap_keys(pub.meta, 1)
    want = pcl.get_bytes_many(keys)
    eps = [("127.0.0.1", server.port)]
    pc = ServeClient(eps, device="cpu", start=False, register=False)
    jc = JServeClient(eps, start=False, register=False)
    try:
        assert [bytes(b) for b in pc.pull_blobs(keys)] == \
            [bytes(b) for b in jc.pull_blobs(keys)] == \
            [bytes(b) for b in want]
        pc._pace_mbps = 20.0
        t0 = time.perf_counter()
        pc.pull_blobs(keys)
        nbytes = sum(len(b) for b in want)
        assert time.perf_counter() - t0 >= nbytes / 20e6
    finally:
        pc.close()
        jc.close()
        pcl.close()


def test_serve_client_resolves_the_knobs(monkeypatch, server):
    monkeypatch.delenv("BFT_CP_HOSTS", raising=False)
    monkeypatch.setenv("BFT_CP_HOST", "127.0.0.1")
    monkeypatch.setenv("BFT_CP_PORT", str(server.port))
    sc = serve_client(device="cpu", start=False)
    assert sc._endpoints == [("127.0.0.1", server.port)]
    sc.close()
    monkeypatch.setenv("BFT_CP_HOSTS", f"127.0.0.1:{server.port}")
    monkeypatch.delenv("BFT_CP_HOST")
    sc = serve_client(device="cpu", start=False, register=False)
    assert sc._endpoints == [("127.0.0.1", server.port)]
    sc.close()
    monkeypatch.delenv("BFT_CP_HOSTS")
    with pytest.raises(RuntimeError, match="BFT_CP_HOSTS"):
        serve_client(device="cpu")


# ---------------------------------------------------------------------------
# serve attribution and the SLO inputs
# ---------------------------------------------------------------------------

def _doc(rows):
    names, idx = [], {}
    ev = {"kind": [], "name": [], "t_wall_us": [], "a": [], "b": []}
    for k, name, t, a, b in rows:
        if name not in idx:
            idx[name] = len(names)
            names.append(name)
        ev["kind"].append(k)
        ev["name"].append(idx[name])
        ev["t_wall_us"].append(float(t))
        ev["a"].append(float(a))
        ev["b"].append(int(b))
    return {"names": names, "events": ev}


_B, _E = flight.SPAN_B, flight.SPAN_E
_ROWS = [
    (_B, "serve.req", 1000, 0, 7),
    (_B, "serve.admit", 1000, 0, 7), (_E, "serve.admit", 1010, 0, 7),
    (_B, "serve.queue", 1010, 0, 7),
    (_B, "serve.pull", 1200, 0, 3),
    (_B, "serve.pull.ep", 1210, 0, 0),
    (_B, "serve.failover", 1300, 0, 3),
    (_E, "serve.failover", 1400, 0, 3),
    (_E, "serve.pull.ep", 1390, 12345, 0),
    (_E, "serve.pull", 1400, 1, 3),
    (_E, "serve.queue", 1500, 0, 7),
    (_B, "serve.linger", 1500, 0, 7), (_E, "serve.linger", 1600, 0, 7),
    (_B, "serve.decode", 1600, 0, 7), (_E, "serve.decode", 1900, 0, 7),
    (_E, "serve.req", 2000, 5, 7),
    (_B, "serve.req", 5000, 0, 8),   # incomplete: ignored
]


@pytest.mark.parametrize("rows", [_ROWS, [], _ROWS[:1]],
                         ids=["buckets", "empty", "incomplete"])
def test_analyze_serve_matches_jax(rows):
    doc = _doc(rows)
    rep = flight.analyze_serve(doc)
    assert rep == jflight.analyze_serve(doc)
    assert flight.SERVE_PHASES == jflight.SERVE_PHASES
    if not rows or len(rows) == 1:
        assert rep is None
        return
    (tr,) = rep["traces"]
    ph = tr["phases"]
    assert (ph["swap_blocked"], ph["queue"], ph["reply"]) == \
        (200.0, 290.0, 100.0)
    assert sum(ph.values()) == pytest.approx(tr["dur_us"])
    assert flight.format_serve_report(rep) == \
        jflight.format_serve_report(rep)


def _seeded(monkeypatch, spec, burn="2.0"):
    for pre in ("BFT_", "BLUEFOG_"):
        monkeypatch.setenv(pre + "SLO", spec)
        monkeypatch.setenv(pre + "SLO_BURN", burn)
    return ts.TimeSeriesStore(), jts.TimeSeriesStore()


def _storm(feed):
    t0 = 1000.0
    nerr = 0
    for i in range(60):
        feed(t0 + i, 10.0 * i, 0.0)
    yield t0 + 59
    for i in range(60, 80):
        nerr += 10
        feed(t0 + i, 10.0 * i, float(nerr))
    yield t0 + 79
    for i in range(80, 100):
        feed(t0 + i, 10.0 * i, float(nerr))
    yield t0 + 99


def _spike(feed):
    t0 = 2000.0
    for i in range(600):
        feed(t0 + i, 100.0 * i, 0.0)
    for i in range(600, 602):
        feed(t0 + i, 100.0 * i, float((i - 599) * 100))
    yield t0 + 601


def _shed(feed):
    t0 = 3000.0
    for i in range(30):
        feed(t0 + i, 10.0 * i, 1.0 * i)
    yield t0 + 29


_SLO_CASES = {"storm": ("serve_p99:50ms@10s", "slo.breach.serve_p99", _storm),
              "fast_spike": ("serve_p99:50ms@10s", "slo.breach.serve_p99",
                             _spike),
              "avail_shed": ("serve_avail:99@10s", "slo.shed", _shed)}


@pytest.mark.parametrize("case", list(_SLO_CASES))
def test_slo_burn_rates_match_jax(monkeypatch, case):
    """The burn-rate engine on the client's series (``slo.requests`` and
    its error series), ``tests/test_slo.py:130-228``'s timelines: the port's
    store and JAX's give the same status at every evaluation."""
    spec, err_name, timeline = _SLO_CASES[case]
    stores = _seeded(monkeypatch, spec)
    pairs = [(s.series("slo.requests", "counter", "last"),
              s.series(err_name, "counter", "last")) for s in stores]

    def feed(t, req, err):
        for r, e in pairs:
            r.add(t, req)
            e.add(t, err)

    statuses = []
    for now in timeline(feed):
        for s in stores:
            s._evaluate_slos(now)
        port, jax_ = (s.slo_status() for s in stores)
        assert port == jax_
        assert [a["name"] for a in stores[0].active_alerts()] == \
            [a["name"] for a in stores[1].active_alerts()]
        statuses.append(port[0]["active"])
    assert statuses == {"storm": [False, True, False],
                        "fast_spike": [False],
                        "avail_shed": [True]}[case]


def test_traced_client_ring_and_slo_series_read_by_jax(knobs, monkeypatch,
                                                       server):
    """A traced port client with SLOs: its ring gives the same report in
    both packages' ``analyze_serve``, and the time series it publishes
    under ``bf.ts.<SERVE_TS_RANK_BASE + cid>`` carries its ``slo.*``
    series to JAX's reader."""
    for pre in ("BFT_", "BLUEFOG_"):
        monkeypatch.setenv(pre + "TRACE_SERVE", "1")
        monkeypatch.setenv(pre + "SLO", "serve_p99:50ms@5m,serve_avail:99@5m")
    flight.reset_for_job()
    eps = [("127.0.0.1", server.port)]
    pcl = native.ControlPlaneClient("127.0.0.1", server.port, rank=0)
    snap.SnapshotPublisher(pcl, shards=2).publish(
        [np.full(50, 2.0, np.float32)], 1, step=1)
    sc = ServeClient(eps, _add_first, device="cpu", poll_s=0.05)
    try:
        assert sc.wait_ready(WAIT_S)
        reqs0 = metrics.counter("slo.requests").value
        for _ in range(6):
            sc.infer(np.zeros(2, np.float32), WAIT_S)
        assert metrics.counter("slo.requests").value == reqs0 + 6
        rank = ts.SERVE_TS_RANK_BASE + sc._cid
        jcl = jnative.ControlPlaneClient("127.0.0.1", server.port, rank=1)
        _until(lambda: (jts.read_rank(jcl, rank) or {}).get("series", {})
               .get("slo.requests") is not None,
               "the client's SLO series published", 10.0)
        doc = jts.read_rank(jcl, rank)
        assert doc == ts.read_rank(pcl, rank)
        assert any(n.startswith("slo.budget.") for n in doc["series"])
        jcl.close()
        _until(lambda: metrics.gauge("slo.request_p99_us").value > 0,
               "the p99 gauge set")
        ring = flight.recorder().snapshot()
        rep = flight.serve_report()
        assert rep == flight.analyze_serve(ring) == \
            jflight.analyze_serve(ring)
        assert rep["requests"] == 6 and rep["pulls"] >= 1
        assert all(t["ver"] == 1 for t in rep["traces"])
    finally:
        sc.close()
        pcl.close()
        flight.reset_for_job()


def _flow_pairs_across_pids(merged):
    starts, ends = {}, {}
    for e in merged:
        if e.get("cat") == "bf.flow":
            (starts if e["ph"] == "s" else ends).setdefault(
                e["id"], set()).add(e["pid"])
    return [fid for fid, sp in starts.items() if ends.get(fid, set()) - sp]


def test_e2e_merged_trace_lineage_and_phase_sum(knobs, monkeypatch,
                                                tmp_path, server):
    """``tests/test_slo.py:396`` on the port: requests served against a
    live traced publisher child, the two processes' rings merged into one
    chrome trace with a cross-process shard flow pair, the phase buckets
    summing to the latency within 10 %, the lineage naming the exact
    producing step; JAX's analyzer agrees on the client's dump."""
    monkeypatch.setenv("BFT_TRACE_SERVE", "1")
    flight.reset_for_job()
    dump = tmp_path / "pub_flight.json"
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent))
    proc = subprocess.Popen(
        [sys.executable, str(PUB_CHILD), "--port", str(server.port),
         "--shards", "4", "--elems", "4000", "--period-ms", "100",
         "--keep", "4", "--flight-dump", str(dump), "--flight-rank", "1"],
        stdout=subprocess.DEVNULL, env=env)
    cl = native.ControlPlaneClient("127.0.0.1", server.port, 0)
    sc = ServeClient([("127.0.0.1", server.port)], _add_first, device="cpu")
    try:
        assert sc.wait_ready(60), "no snapshot pulled"
        for _ in range(5):
            lo = sc.version()
            out = sc.infer(np.zeros(3, np.float32), WAIT_S)
            assert float(lo) <= float(out[0])
        ver = sc.version()
        lin = snap.read_lineage(cl, ver)
        assert lin is not None and lin["ver"] == ver and lin["step"] == ver
        time.sleep(0.5)
        proc.terminate()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        sc.close()
        cl.close()
    try:
        client_doc = flight.build_dump("slo-e2e-test")
        pub_doc = json.loads(dump.read_text())
        assert pub_doc["meta"]["rank"] == 1
        merged = flight.merge_dumps([client_doc, pub_doc])
        assert len({e["pid"] for e in merged}) >= 2
        assert _flow_pairs_across_pids(merged)
        rep = flight.analyze_serve(client_doc)
        assert rep == jflight.analyze_serve(client_doc)
        assert rep["requests"] >= 5
        covs = sorted(t["coverage"] for t in rep["traces"])
        assert 0.9 <= covs[len(covs) // 2] <= 1.1, covs
        assert all(t["ver"] >= 1 for t in rep["traces"])
    finally:
        flight.reset_for_job()


def _readline(proc, timeout: float = 60.0) -> str:
    out = []
    t = threading.Thread(target=lambda: out.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout)
    assert out, f"no line from the shard server within {timeout} s"
    return out[0]


def _spawn_shard(i: int, port: int = 0, rejoin: bool = False):
    cmd = [sys.executable, str(SHARD_SERVER), "--port", str(port), "--world",
           "1", "--shard", str(i), "--expect-peers"] + \
        (["--rejoin"] if rejoin else [])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stdin=subprocess.PIPE, text=True)
    line = _readline(proc)
    assert line.startswith("BF_SHARD_PORT"), f"shard {i}: {line!r}"
    return proc, int(line.split()[1])


def _peers(proc, ring: str) -> None:
    proc.stdin.write(f"BF_SHARD_PEERS {ring}\n")
    proc.stdin.flush()


def test_traced_failover_across_shard_kill_and_rejoin(knobs, monkeypatch):
    """``tests/test_chaos.py:1916`` on the port: a traced client rides a
    shard SIGKILL and its rejoin on the same port with an unbroken trace:
    requests complete on the held snapshot during the outage, the ring
    holds a closed ``serve.failover`` span, the client swaps past the
    failover, and the lineage names the exact step."""
    from bluefog_tpu_torch.runtime.router import ShardRouter

    native.load()
    monkeypatch.setenv("BFT_CP_BACKOFF_MS", "20")
    monkeypatch.setenv("BFT_TRACE_SERVE", "1")
    flight.reset_for_job()
    servers = [_spawn_shard(i) for i in range(2)]
    procs = [p for p, _ in servers]
    try:
        ring = ",".join(f"127.0.0.1:{port}" for _, port in servers)
        for p, _ in servers:
            _peers(p, ring)
        for i, (p, _) in enumerate(servers):
            assert _readline(p).startswith("BF_SHARD_READY"), i
        eps = [("127.0.0.1", port) for _, port in servers]
        pub_r = ShardRouter(eps, 0, streams=1)
        pub = snap.SnapshotPublisher(pub_r, shards=4)
        pub.publish([np.full(500, 1.0, np.float32)], 1, step=1)
        sc = ServeClient(eps, _add_first, device="cpu")
        try:
            assert sc.wait_ready(WAIT_S)
            np.testing.assert_array_equal(
                sc.infer(np.zeros(2, np.float32), WAIT_S),
                np.ones(2, np.float32))
            victim, port = servers[1]
            victim.send_signal(signal.SIGKILL)
            victim.wait()
            pub.publish([np.full(500, 2.0, np.float32)], 2, step=2)
            _until(lambda: sc.stats()["pull_failures"] >= 1,
                   "a failed stripe pull after the kill")
            assert float(sc.infer(np.zeros(2, np.float32), WAIT_S)[0]) >= 1
            nproc, nport = _spawn_shard(1, port=port, rejoin=True)
            procs.append(nproc)
            _peers(nproc, ",".join(f"127.0.0.1:{p}"
                                   for p in (servers[0][1], port)))
            assert _readline(nproc).startswith("BF_SHARD_READY")
            pub.publish([np.full(500, 3.0, np.float32)], 3, step=3)
            _until(lambda: sc.version() >= 3,
                   "the client swapped past the failover", 25.0)
            assert float(sc.infer(np.zeros(2, np.float32), WAIT_S)[0]) >= 3
            rep = flight.serve_report()
            assert rep is not None and rep["requests"] >= 3
            assert rep["failovers"] >= 1
            assert rep == jflight.analyze_serve(flight.recorder().snapshot())
            lin = snap.read_lineage(pub_r, 3)
            assert lin is not None and lin["step"] == 3
        finally:
            sc.close()
            pub_r.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stdout.close()
            p.stdin.close()
        native.fault_disarm()
        flight.reset_for_job()


# ---------------------------------------------------------------------------
# the slice as a whole: a small LM served from its snapshots
# ---------------------------------------------------------------------------

_CFG = dict(vocab_size=128, num_layers=2, num_heads=4, d_model=64, d_ff=256)
_S = 32


def test_small_lm_served_matches_jax_apply(knobs, server):
    import jax
    import jax.numpy as jnp
    from functools import partial

    from bluefog_tpu.models.transformer import TransformerLM as JaxLM
    from bluefog_tpu.parallel.flash import flash_attention as jax_flash
    from bluefog_tpu_torch.models import TransformerLM
    from bluefog_tpu_torch.parallel.flash import flash_attention
    from bluefog_tpu_torch.utils import params_from_jax

    jm = JaxLM(dtype=jnp.float32, attn_fn=partial(jax_flash, causal=True,
                                                  interpret=True), **_CFG)
    jparams = jm.init(jax.random.PRNGKey(15), np.zeros((1, _S), np.int32))
    skeleton = TransformerLM(dtype=torch.float32, device="cpu",
                             attn_fn=flash_attention, **_CFG)
    names = [n for n, _ in skeleton.named_parameters()]

    def model_fn(params, xs):
        return torch.func.functional_call(
            skeleton, dict(zip(names, params)), (xs,))[:, -1]

    toks = np.random.default_rng(16).integers(
        0, _CFG["vocab_size"], (3, _S)).astype(np.int64)
    pcl = native.ControlPlaneClient("127.0.0.1", server.port, rank=0)
    pub = snap.SnapshotPublisher(pcl, shards=3)
    sc = ServeClient([("127.0.0.1", server.port)], model_fn, device="cpu")
    try:
        rng = np.random.default_rng(17)
        params = jax.tree_util.tree_map(np.asarray, jparams)
        for ver in (1, 2):
            if ver == 2:   # a perturbed second version
                params = jax.tree_util.tree_map(
                    lambda a: a + 0.05 * rng.standard_normal(a.shape)
                    .astype(a.dtype), params)
            state = params_from_jax(params)
            pub.publish([state[n] for n in names], ver, step=ver)
            _until(lambda: sc.version() == ver, f"version {ver} served")
            got = np.stack([f.result(WAIT_S)
                            for f in [sc.submit(t) for t in toks]])
            want = np.asarray(jm.apply(params, toks.astype(np.int32)))[:, -1]
            assert got.shape == want.shape == (3, _CFG["vocab_size"])
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())
    finally:
        sc.close()
        pcl.close()


# ---------------------------------------------------------------------------
# train-while-serve at world 4 (gloo children)
# ---------------------------------------------------------------------------

def test_world4_train_while_serve_both_clients(knobs, tmp_path,
                                               monkeypatch):
    rng = np.random.default_rng(15)
    np.savez(tmp_path / "inputs.npz",
             x=rng.standard_normal((4, 5, 6)).astype(np.float32))
    srv = native.ControlPlaneServer(4, 0)
    try:
        for k, v in {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(srv.port),
                     "BFT_CP_SERVE": "0", "BFT_CP_CONNECT_TIMEOUT": "60",
                     "BFT_SERVE_PUBLISH_EVERY": "1",
                     "BFT_SERVE_SHARDS": "2",
                     "BFT_FLIGHT_DIR": str(tmp_path),
                     "BFT_HEARTBEAT_INTERVAL": "600"}.items():
            monkeypatch.setenv(k, v)
        procs = spawn("train_serve", str(tmp_path))
        eps = [("127.0.0.1", srv.port)]
        ack = native.ControlPlaneClient("127.0.0.1", srv.port, 100)
        pc = ServeClient(eps, _add_first, device="cpu")
        jc = JServeClient(eps, model_fn=_add_first)
        served = {}
        try:
            for step in range(1, STEPS + 1):
                _until(lambda: pc.refresh() == step and jc.refresh() == step,
                       f"both clients serving version {step}", 120.0)
                x = np.full(6, 0.25, np.float32)
                p_out, j_out = pc.infer(x, WAIT_S), jc.infer(x, WAIT_S)
                np.testing.assert_array_equal(p_out, j_out)
                served[step] = [t.numpy().copy() for t in pc.params()]
                for a, b in zip(served[step], jc.params()):
                    np.testing.assert_array_equal(a, b)
                ack.put("test.serve.ack", step)
            outs = collect(procs, str(tmp_path))
        finally:
            pc.close()
            jc.close()
            ack.close()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for step, leaves in served.items():
            for i, a in enumerate(leaves):
                np.testing.assert_array_equal(a, outs[0][f"step{step}_p{i}"])
        assert not np.array_equal(served[1][0], served[STEPS][0])
    finally:
        srv.stop()
