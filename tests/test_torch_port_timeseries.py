"""Port vs JAX: the live time-series plane, on the same numpy inputs.

For each of ``tests/test_timeseries.py``'s thirteen tests that need no
window, the same inputs go through ``bluefog_tpu.runtime.timeseries`` and
the port's ``bluefog_tpu_torch.runtime.timeseries`` and the outputs are
compared:

* tier contents, windows, rates, trends and the mixing-rate fit, to 1e-12
  (the two are the same numpy code, so they agree exactly in practice);
* ``pack_doc`` bytes identical, and each package's ``unpack_doc`` reading
  the other's blob;
* ``build_doc`` documents equal, and the rule engine firing and clearing
  at the same sample times;
* the ``format_top`` frame identical, character for character.

The six cases of ``test_timeseries.py`` on the ``bf_hosted_ts`` fixture
drive window optimizers, which the port does not have yet (ROADMAP Queue
1, item 6); they wait for it. Last, the port publishes ``bf.ts.<rank>``
through a control-plane server and JAX's ``read_rank`` reads it back.
"""

import dataclasses
import socket
import time

import numpy as np
import pytest

from bluefog_tpu.runtime import flight as jflight
from bluefog_tpu.runtime import metrics as jmetrics
from bluefog_tpu.runtime import native as jnative
from bluefog_tpu.runtime import timeseries as jts
from bluefog_tpu_torch.runtime import control_plane as cp
from bluefog_tpu_torch.runtime import flight, metrics, native
from bluefog_tpu_torch.runtime import timeseries as ts

TOL = 1e-12
BOTH = {"jax": (jts, jmetrics, jflight), "port": (ts, metrics, flight)}


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# ring history
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res,cap,agg,n,start", [
    (1.0, 8, "last", 20, 1000.0),
    (10.0, 4, "mean", 10, 2000.0),
    (1.0, 4, "max", 3, 1.0),
    (1.0, 256, "sum", 600, 3000.0),
])
def test_tier_wraps_and_aggregates(res, cap, agg, n, start):
    rng = np.random.default_rng(0)
    times = start + np.cumsum(rng.uniform(0.05, 0.6, n))
    vals = rng.standard_normal(n)
    out = {}
    for pkg, (mod, _, _) in BOTH.items():
        tier = mod._Tier(res, cap, agg)
        for t, v in zip(times, vals):
            tier.add(float(t), float(v))
        out[pkg] = tier.samples()
    _close(out["jax"][0], out["port"][0])
    _close(out["jax"][1], out["port"][1])
    # the JAX test's own pins hold on the port's tier
    t = ts._Tier(1.0, 8, "last")
    for i in range(20):
        t.add(1000.0 + i, float(i))
    times, vals = t.samples()
    assert len(times) == 9 and vals[-1] == 19.0 and times[0] == 1011.0


def test_series_window_rate_trend():
    rng = np.random.default_rng(1)
    values = np.cumsum(rng.uniform(5.0, 15.0, 600))  # a counter at ~10/s
    got = {}
    for pkg, (mod, _, _) in BOTH.items():
        s = mod.Series("t.x", "counter", "last")
        for i, v in enumerate(values):
            s.add(5000.0 + i, float(v))
        got[pkg] = {
            "w30": s.window(30), "w500": s.window(500),
            "rate": s.rate(60), "trend": s.trend(120),
            "latest": s.latest()}
    j, p = got["jax"], got["port"]
    for key in ("w30", "w500"):
        _close(j[key][0], p[key][0])
        _close(j[key][1], p[key][1])
    _close(j["rate"], p["rate"])
    _close(j["trend"], p["trend"])
    assert j["latest"] == p["latest"]
    assert p["rate"] == pytest.approx(10.0, rel=0.05)
    # a span longer than the 1 s tier falls back to a coarser tier
    assert p["w500"][0][-1] - p["w500"][0][0] >= 300


def test_mixing_rate_fit_from_decay():
    rng = np.random.default_rng(2)
    decay = 100.0 * (0.7 ** np.arange(12)) * rng.uniform(0.95, 1.05, 12)
    got = {}
    for pkg, (mod, _, _) in BOTH.items():
        store = mod.TimeSeriesStore()
        d = store.series("opt.consensus_dist")
        for i, v in enumerate(decay):
            d.add(7000.0 + i, float(v))
        store._derive(7012.0)
        got[pkg] = (store._series["opt.mixing_rate"].last_v,
                    store._series["opt.consensus_stalled"].last_v)
    _close(got["jax"], got["port"])
    assert got["port"][0] == pytest.approx(0.7, rel=0.05)
    assert got["port"][1] == 0.0


# ---------------------------------------------------------------------------
# publication wire format
# ---------------------------------------------------------------------------

def test_pack_unpack_roundtrip_and_bad_magic():
    doc = {"schema": 1, "rank": 3, "series": {"a": {"v": [1.5, -2.25e-7]}},
           "latest": {"b": [12, 0.1]}, "alerts": []}
    blob = ts.pack_doc(doc)
    assert blob[:4] == b"BFT1"
    assert blob == jts.pack_doc(doc)
    assert ts.unpack_doc(jts.pack_doc(doc)) == doc
    assert jts.unpack_doc(blob) == doc
    for mod in (ts, jts):
        with pytest.raises(ValueError):
            mod.unpack_doc(b"NOPE" + blob[4:])


def _docs(mod, n=5, t0=9000.0):
    store = mod.TimeSeriesStore()
    s = store.series("opt.step")
    for i in range(n):
        s.add(t0 + i, float(i))
    es = store._edges.setdefault("0->1", mod.EdgeStats())
    es.on_start(4096.0)
    es.on_transit(250.0)
    doc1 = store.build_doc(0, 2, t0 + n, 1.0)
    doc2 = store.build_doc(0, 2, t0 + n + 1, 1.0)
    return doc1, doc2


def test_build_doc_delta_and_latest_row():
    (j1, j2), (p1, p2) = _docs(jts), _docs(ts)
    assert p1 == j1 and p2 == j2
    assert ts.pack_doc(p1) == jts.pack_doc(j1)
    assert "opt.step" in p1["series"] and "opt.step" not in p2["series"]
    assert p2["latest"]["opt.step"][1] == 4.0
    # each package's accumulator over the other's blobs
    for acc_mod, pack in ((ts, jts.pack_doc), (jts, ts.pack_doc)):
        acc = acc_mod.HistoryAccumulator()
        acc.update(0, acc_mod.unpack_doc(pack(j1)))
        hist = acc.series[(0, "opt.step")]
        assert [round(t) for t, _ in hist][-2:] == [9003, 9004]
        acc.update(0, acc_mod.unpack_doc(pack(j2)))
        assert acc.latest(0, "opt.step") == 4.0


def test_full_publication_carries_tier_history():
    docs = {}
    for pkg, (mod, _, _) in BOTH.items():
        store = mod.TimeSeriesStore()
        s = store.series("opt.step")
        for i in range(120):
            s.add(10000.0 + i, float(i))
        docs[pkg] = store.build_doc(0, 0, 10120.0, 1.0)  # seq 0: full
    assert docs["port"] == docs["jax"]
    assert "10" in docs["port"]["hist"]["opt.step"]


# ---------------------------------------------------------------------------
# alert rules
# ---------------------------------------------------------------------------

_SPEC = ("wal_lag:cp.repl_lag>100:for=5,mass_drift:off,garbage,"
         "custom:opt.step.rate<0.5:for=2,ge:x>=3,le:y<=-1.5:for=0.5")


def test_parse_rules_grammar_override_off_malformed():
    for spec in (None, "", _SPEC):
        got = [dataclasses.astuple(r) for r in ts.parse_rules(spec)]
        want = [dataclasses.astuple(r) for r in jts.parse_rules(spec)]
        assert got == want
    rules = {r.name: r for r in ts.parse_rules(_SPEC)}
    assert rules["wal_lag"].threshold == 100.0
    assert "mass_drift" not in rules and "straggler" in rules
    assert rules["le"].op == "<=" and rules["le"].for_sec == 0.5


def test_rule_engine_fires_after_sustain_and_clears():
    """The same lag samples at the same times: both engines fire, stay
    active and clear at the same sample, each counting one alert.fired
    and leaving one alert.wal_lag flight instant."""
    rng = np.random.default_rng(3)
    times = 1000.0 + np.cumsum(rng.uniform(0.5, 2.0, 30))
    lag = np.where(np.arange(30) % 12 < 8, 500.0, 0.0)
    trail = {}
    for pkg, (mod, met, fl) in BOTH.items():
        store = mod.TimeSeriesStore()
        store._rules = mod.parse_rules("wal_lag:cp.repl_lag>100:for=5")
        store._rule_state = {r.name: mod._RuleState() for r in store._rules}
        series = store.series("cp.repl_lag", "gauge", "max")
        fired0 = met.counter("alert.fired").value
        n0 = fl.recorder()._n
        states = []
        for t, v in zip(times, lag):
            series.add(float(t), float(v))
            store._evaluate_rules(float(t))
            states.append([a["name"] for a in store.active_alerts()])
        snap = fl.recorder().snapshot()
        names = snap["names"]
        fires = sum(1 for n in snap["events"]["name"][-(fl.recorder()._n
                                                        - n0):]
                    if names[n] == "alert.wal_lag")
        trail[pkg] = (states, met.counter("alert.fired").value - fired0,
                      fires)
    assert trail["port"] == trail["jax"]
    states, fired, fires = trail["port"]
    assert fired >= 2 and fires == fired
    assert [] in states and ["wal_lag"] in states


def test_sampler_records_bindings_and_rates():
    got = {}
    for pkg, (mod, met, _) in BOTH.items():
        met.gauge("opt.step").set(40.0)
        met.counter("win.drain_bytes").inc(1000)
        store = mod.TimeSeriesStore()
        store.sample(now=2000.0)
        met.gauge("opt.step").set(50.0)
        met.counter("win.drain_bytes").inc(3000)
        store.sample(now=2002.0)
        got[pkg] = {n: store._series[n].latest()
                    for n in ("opt.step", "opt.step.rate",
                              "win.drain_bytes.rate")}
    assert got["port"] == got["jax"]
    assert got["port"]["opt.step.rate"][1] == pytest.approx(5.0)
    assert got["port"]["win.drain_bytes.rate"][1] == pytest.approx(1500.0)


# ---------------------------------------------------------------------------
# per-edge estimators and consumer-side matching
# ---------------------------------------------------------------------------

def test_edge_estimator_from_real_flight_ring():
    """The same flow events in each package's flight ring feed the same
    edge estimator (bytes and deposits exactly; transit from each ring's
    own clock)."""
    got = {}
    for pkg, (mod, _, fl) in BOTH.items():
        rec = fl.recorder()
        store = mod.TimeSeriesStore()
        store._scan_cursor = getattr(rec, "_n", 0)  # only our events
        nid = rec.intern("edge.0.1")
        did = rec.intern("drain.0")
        for fid, nbytes in ((901, 4096.0), (902, 8192.0), (903, 512.0)):
            rec.rec(fl.FLOW_S, nid, nbytes, fid)
            rec.rec(fl.FLOW_F, did, nbytes, fid)
        store.sample(now=3000.0)
        est = store.edges()["0->1"]
        p50, p99 = est.percentiles()
        assert p50 is not None and p50 >= 0.0 and p99 >= p50
        got[pkg] = (est.deposits, est.bytes, sorted(store._pending),
                    [s[0] for s in store._flow_starts],
                    [f[0] for f in store._flow_finishes])
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (3, 4096.0 + 8192.0 + 512.0)


def test_accumulator_matches_flows_across_ranks():
    rng = np.random.default_rng(4)
    starts = [[int(f), int(1_000_000 + 1000 * f), 512, 0, 2]
              for f in range(1, 9)]
    finishes = [[f, t + int(d)] for (f, t, *_), d in
                zip(starts, rng.integers(100, 9000, len(starts)))]
    got = {}
    for pkg, (mod, _, _) in BOTH.items():
        acc = mod.HistoryAccumulator()
        acc.update(0, {"seq": 1, "ts": 100.0, "series": {}, "edges": {},
                       "flows": {"starts": starts, "finishes": []}})
        acc.update(2, {"seq": 1, "ts": 100.0, "series": {}, "edges": {},
                       "flows": {"starts": [], "finishes": finishes}})
        got[pkg] = acc.edge_transit("0->2")
    _close(got["jax"], got["port"])
    acc = ts.HistoryAccumulator()
    acc.update(0, {"seq": 1, "ts": 100.0, "series": {}, "edges": {},
                   "flows": {"starts": [[7, 1_000_000, 512, 0, 2]],
                             "finishes": []}})
    acc.update(2, {"seq": 1, "ts": 100.0, "series": {}, "edges": {},
                   "flows": {"starts": [], "finishes": [[7, 1_002_500]]}})
    assert acc.edge_transit("0->2") == (2500.0, 2500.0)


def test_silent_rank_detection_and_top_rendering():
    """Each package's store publishes the same ranks; both accumulators
    name rank 2 silent, and the two ``--top`` frames are the same text."""
    now = time.time()
    frames, silent = {}, {}
    for pkg, (mod, _, _) in BOTH.items():
        acc = mod.HistoryAccumulator()
        for r in (0, 1, 3):
            store = mod.TimeSeriesStore()
            store.series("opt.step").add(now, 10.0 + r)
            store.series("opt.step.rate").add(now, 2.5 * r)
            store.series("opt.consensus_dist").add(now, 0.5 / (r + 1))
            es = store._edges.setdefault(f"{r}->0", mod.EdgeStats())
            es.on_start(1e6 * (r + 1))
            es.on_transit(1500.0 * (r + 1))
            acc.update(r, store.build_doc(r, 0, now, 1.0))
        old = mod.TimeSeriesStore()  # rank 2 published long ago
        old.series("opt.step").add(now - 120, 3.0)
        acc.update(2, old.build_doc(2, 0, now - 120, 1.0))
        silent[pkg] = acc.silent_ranks(4, now)
        frames[pkg] = mod.format_top(acc, 4, now=now)
    assert silent["port"] == silent["jax"] == [2]
    assert frames["port"] == frames["jax"]
    assert "SILENT rank(s): [2]" in frames["port"]
    for vals in ([1, 2, 3], [], [5.0, float("nan"), 1.0], [2, 2, 2]):
        assert ts.sparkline(vals) == jts.sparkline(vals)
    assert ts.sparkline([1, 2, 3]) != "" and ts.sparkline([]) == ""


def test_knob_disable_turns_plane_off(monkeypatch):
    monkeypatch.setenv("BFT_TS_DISABLE", "1")
    monkeypatch.setenv("BLUEFOG_TS_DISABLE", "1")
    assert not ts.enabled() and not jts.enabled()
    ts.maybe_sample(force=True, publish=True)  # no-op, no raise
    assert ts.publish_now() is None
    # each package reads only its own knob
    monkeypatch.delenv("BFT_TS_DISABLE")
    assert ts.enabled() and not jts.enabled()
    monkeypatch.delenv("BLUEFOG_TS_DISABLE")
    assert ts.enabled() and jts.enabled()


# ---------------------------------------------------------------------------
# publication through a server, read by the JAX package
# ---------------------------------------------------------------------------

def test_publish_through_server_read_by_jax(monkeypatch):
    """``maybe_sample`` + ``publish_now`` put the port's doc under
    ``bf.ts.0`` (and its active alerts under ``bf.alerts.0``); the JAX
    package's ``read_rank`` and the port's read the same document."""
    monkeypatch.setenv("BFT_ALERT_RULES", "wal_lag:cp.repl_lag>100:for=0")
    monkeypatch.setenv("BFT_TS_INTERVAL", "0")
    ts.reset_for_job()
    port = _free_port()
    server = native.ControlPlaneServer(1, port)
    cl = native.ControlPlaneClient("127.0.0.1", port, 0)
    jcl = jnative.ControlPlaneClient("127.0.0.1", port, 1)
    monkeypatch.setattr(cp, "_client", cl)
    try:
        metrics.gauge("opt.step").set(7.0)
        metrics.gauge("cp.repl_lag").set(500.0)
        ts.maybe_sample(cl, force=True)  # interval 0: samples, no publish
        assert ts.read_rank(cl, 0) is None
        doc = ts.publish_now()
        assert doc is not None and doc["rank"] == 0
        for reader, client in ((jts.read_rank, jcl), (ts.read_rank, cl)):
            got = reader(client, 0)
            assert got == doc
        assert got["latest"]["opt.step"][1] == 7.0
        assert [a["name"] for a in got["alerts"]] == ["wal_lag"]
        assert cl.get_bytes("bf.alerts.0")
    finally:
        metrics.gauge("cp.repl_lag").set(0.0)
        ts.reset_for_job()
        cl.close()
        jcl.close()
        server.stop()
