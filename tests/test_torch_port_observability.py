"""Port vs JAX: the metrics registry, the flight recorder, the optimizer's
step records and the log prefix.

The same calls go into the JAX package's modules and the port's, and the
results must be equal (exact unless stated; timestamps aside, since each
side reads its own clock):

* metrics: one sequence of counter, gauge and histogram calls gives equal
  snapshots, equal ``pack_snapshot`` bytes once the time fields are fixed
  (and each side unpacks the other's blob), equal ``prometheus_text``;
  ``health_from_snapshots``/``format_health`` agree on
  ``tests/test_metrics.py``'s straggler, staleness and mass inputs; an
  unsorted histogram raises on both sides;
* flight: equal ring contents and drop counts at one capacity, the same
  power-of-two rounding, packed dumps readable both ways, equal
  ``analyze_dump``/``chrome_events``/``merge_dumps`` on
  ``tests/test_flight.py``'s documents, the same dump rate limit,
  ``fatal`` dumping and a failing optimizer step re-raising after its
  dump, the ``sys.excepthook`` chain installed by ``bf.init`` and put back
  by ``bf.shutdown``, and ``BFT_FLIGHT_DISABLE=1`` installing the null
  recorder;
* after 3 optimizer steps the ``opt.step`` gauge, the ``opt.step_sec``
  count and ``step_report()["step"]`` equal the JAX ``_FusedOptimizer``'s;
* log records carry ``[rank r / inc 0] `` once ``bf.init`` has run.

The two hot-path timings keep the JAX tests' bounds and take the best of
repeats (the suite shares its cores with other workers).
"""

import json
import logging
import sys
import time
import timeit

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu.runtime import flight as jflight
from bluefog_tpu.runtime import metrics as jmetrics
from bluefog_tpu_torch.runtime import flight as pflight
from bluefog_tpu_torch.runtime import metrics as pmetrics
from conftest import cpu_devices

SIDES = {"jax": (jmetrics, jflight), "port": (pmetrics, pflight)}


@pytest.fixture(autouse=True)
def _dumps_in_tmp(tmp_path, monkeypatch):
    """Every dump of either package lands under ``tmp_path``."""
    for prefix in ("BLUEFOG", "BFT"):
        monkeypatch.setenv(f"{prefix}_FLIGHT_DIR", str(tmp_path))
    yield
    jflight.reset_for_job()
    pflight.reset_for_job()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _fill(mod):
    """One sequence of instrument calls into a fresh registry."""
    r = mod.Registry()
    c = r.counter("t.hits")
    c.inc()
    c.inc(4)
    r.counter("ops.total").inc(3)
    g = r.gauge("opt.step")
    g.set(3)
    g.add(2.5)
    r.gauge("mailbox.bytes").set(1024)
    h = r.histogram("t.lat", bounds=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.1):
        h.observe(v)
    d = r.histogram("opt.step_sec")
    for v in (0.0002, 0.002, 12.0, 1e-3):
        d.observe(v)
    return r


def _snaps(ts=1_700_000_000.25):
    out = {}
    for side, (mod, _) in SIDES.items():
        r = _fill(mod)
        snap = r.snapshot(include_native=False) if side == "jax" else \
            r.snapshot()
        snap["meta"].update(ts=ts, rank=3)
        out[side] = snap
    return out


def test_snapshots_equal():
    jr, pr = _fill(jmetrics), _fill(pmetrics)
    j, p = jr.snapshot(include_native=False), pr.snapshot()
    assert abs(j["meta"].pop("ts") - p["meta"].pop("ts")) < 60.0
    assert j == p
    # reset zeroes in place on both sides, instrument identity preserved
    c = pr.counter("t.hits")
    jr.reset()
    pr.reset()
    assert pr.counter("t.hits") is c and c.value == 0
    j, p = jr.snapshot(include_native=False), pr.snapshot()
    j["meta"].pop("ts")
    p["meta"].pop("ts")
    assert j == p


def test_packed_snapshots_byte_compatible():
    snaps = _snaps()
    jblob = jmetrics.pack_snapshot(snaps["jax"])
    pblob = pmetrics.pack_snapshot(snaps["port"])
    assert jblob == pblob
    assert pmetrics.unpack_snapshot(jblob) == jmetrics.unpack_snapshot(jblob)
    assert jmetrics.unpack_snapshot(pblob) == pmetrics.unpack_snapshot(pblob)
    back = pmetrics.unpack_snapshot(pblob)
    assert back["meta"] == {"schema": 1, "rank": 3, "inc": 0,
                            "ts": 1_700_000_000.25}
    for bad in (b"XXXX" + pblob[4:], pblob[:10]):
        for mod in (jmetrics, pmetrics):
            with pytest.raises(ValueError):
                mod.unpack_snapshot(bad)


def test_prometheus_text_equal():
    snaps = _snaps()
    text = pmetrics.prometheus_text(snaps["port"])
    assert text == jmetrics.prometheus_text(snaps["jax"])
    assert "# HELP bluefog_opt_step optimizer step counter of this rank" \
        in text
    assert 'bluefog_t_lat_bucket{rank="3",le="+Inf"} 5' in text


def _snap(rank, step=None, mass=None, minted=None, ts=1000.0, epoch=0):
    gauges = {"membership.epoch": float(epoch)}
    if step is not None:
        gauges["opt.step"] = float(step)
    if mass is not None:
        gauges["pushsum.mass"] = float(mass)
    if minted is not None:
        gauges["pushsum.minted"] = float(minted)
    return {"meta": {"schema": 1, "rank": rank, "inc": 0, "ts": ts},
            "counters": {}, "gauges": gauges, "hists": {}}


HEALTH_CASES = {
    "straggler": ({0: _snap(0, step=50), 1: _snap(1, step=49),
                   2: _snap(2, step=40)}, 3),
    "staleness": ({0: _snap(0, step=10), 1: _snap(1, step=10, ts=940.0)},
                  3),
    "mass_ok": ({0: _snap(0, mass=2.0, minted=2.0),
                 1: _snap(1, mass=2.0, minted=2.0)}, 2),
    "mass_drift": ({0: _snap(0, mass=1.25, minted=2.0),
                    1: _snap(1, mass=2.0, minted=2.0)}, 2),
    "mass_stale": ({0: _snap(0, mass=2.0, minted=2.0),
                    1: _snap(1, mass=2.0, minted=2.0, ts=400.0)}, 2),
    "format": ({0: _snap(0, step=9, mass=1.0, minted=1.0),
                1: _snap(1, step=2)}, 3),
}


@pytest.mark.parametrize("threshold", [None, "1"])
@pytest.mark.parametrize("case", list(HEALTH_CASES))
def test_health_equal(case, threshold, monkeypatch):
    if threshold is not None:
        monkeypatch.setenv("BLUEFOG_STRAGGLER_STEPS", threshold)
        monkeypatch.setenv("BFT_STRAGGLER_STEPS", threshold)
    snaps, world = HEALTH_CASES[case]
    j = jmetrics.health_from_snapshots(snaps, world, interval=1.0, now=1000.0)
    p = pmetrics.health_from_snapshots(snaps, world, interval=1.0, now=1000.0)
    assert p == j
    assert pmetrics.format_health(p) == jmetrics.format_health(j)
    if case == "straggler":
        assert p["stragglers"] == ([1, 2] if threshold else [2])


def test_histogram_rejects_unsorted_bounds():
    for mod in (jmetrics, pmetrics):
        with pytest.raises(ValueError, match="strictly increasing"):
            mod.Registry().histogram("bad", bounds=(1.0, 0.5))


def test_counter_hot_path_is_cheap():
    c = pmetrics.Registry().counter("bench")
    n = 100_000
    per = min(timeit.repeat("inc()", globals={"inc": c.inc},
                            number=n, repeat=5)) / n
    assert per < 500e-9, f"counter inc costs {per * 1e9:.0f} ns"


def test_prometheus_file_on_the_cadence(tmp_path, monkeypatch):
    prom = tmp_path / "scrape.prom"
    monkeypatch.setenv("BFT_METRICS_PROM", str(prom))
    monkeypatch.setenv("BFT_METRICS_INTERVAL", "0.2")
    bft.init(device="cpu")
    try:
        pmetrics.gauge("opt.step").set(4)
        deadline = time.monotonic() + 10.0
        while not prom.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert "bluefog_opt_step{rank=\"0\"} 4" in prom.read_text()
        pmetrics.gauge("opt.step").set(5)
    finally:
        bft.shutdown()         # the final flush
    assert "bluefog_opt_step{rank=\"0\"} 5" in prom.read_text()
    assert pmetrics._publisher is None


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _ring_fill(mod, cap=256, n=300):
    r = mod.FlightRecorder(capacity=cap)
    nid = r.intern("ev")
    for i in range(n):
        r.rec(mod.INSTANT, nid, b=i)
    with r.span("op", a=7.5, b=3):
        r.instant("mark")
    r.counter("gauge", 42)
    return r.snapshot()


def test_ring_contents_and_drops_equal():
    j, p = _ring_fill(jflight), _ring_fill(pflight)
    for s in (j, p):
        assert s["events"]["t_wall_us"] == sorted(s["events"]["t_wall_us"])
        s.pop("anchor")
        s["events"].pop("t_wall_us")
    assert p == j
    assert p["recorded"] == 304 and p["dropped"] == 48


@pytest.mark.parametrize("cap", [1, 255, 256, 257, 1000, 4096, 5000])
def test_capacity_rounds_like_jax(cap):
    assert pflight.FlightRecorder(capacity=cap).capacity == \
        jflight.FlightRecorder(capacity=cap).capacity


def _synth_doc(mod, events):
    """events: (kind, name, t_us, a, b) -> the dump document's shape (the
    helper of tests/test_flight.py)."""
    names, ids = [], {}
    cols = {"kind": [], "name": [], "t_wall_us": [], "a": [], "b": []}
    for kind, name, t, a, b in events:
        nid = ids.setdefault(name, len(names))
        if nid == len(names):
            names.append(name)
        cols["kind"].append(kind)
        cols["name"].append(nid)
        cols["t_wall_us"].append(float(t))
        cols["a"].append(float(a))
        cols["b"].append(int(b))
    return {"names": names, "events": cols}


def _phase_doc(m):
    B, E, S, F = m.SPAN_B, m.SPAN_E, m.FLOW_S, m.FLOW_F
    return _synth_doc(m, [
        (B, "opt.step", 0, 0, 5),
        (B, "opt.local", 0, 0, 0), (E, "opt.local", 100, 0, 0),
        (B, "opt.pack", 100, 0, 0), (E, "opt.pack", 200, 0, 0),
        (B, "opt.gossip", 200, 0, 0),
        (B, "win.wire", 200, 0, 0), (E, "win.wire", 400, 0, 0),
        (S, "edge.0.2", 390, 1000, 77),
        (S, "edge.0.3", 395, 3000, 78),
        (B, "win.drain", 400, 0, 0),
        (B, "win.fold", 500, 0, 0), (E, "win.fold", 600, 0, 0),
        (F, "drain.1", 600, 500, 99),
        (E, "win.drain", 700, 0, 0),
        (E, "opt.gossip", 700, 0, 0),
        (B, "opt.unpack", 700, 0, 0), (E, "opt.unpack", 800, 0, 0),
        (E, "opt.step", 1000, 0, 5),
    ])


def _merge_docs(m):
    B, E, S = m.SPAN_B, m.SPAN_E, m.FLOW_S
    doc0 = _synth_doc(m, [(B, "opt.step", 1000, 0, 1),
                          (S, "edge.0.1", 1500, 64, 42),
                          (E, "opt.step", 2000, 0, 1)])
    doc0["meta"] = {"rank": 0}
    doc1 = _synth_doc(m, [(m.FLOW_F, "drain.0", 1800, 64, 42)])
    doc1["meta"] = {"rank": 1}
    return [doc0, doc1]


def test_attribution_and_chrome_equal():
    rep = pflight.analyze_dump(_phase_doc(pflight))
    assert rep == jflight.analyze_dump(_phase_doc(jflight))
    assert rep["step"] == 5 and rep["other_sec"] == pytest.approx(200e-6)
    assert pflight.format_report(rep) == jflight.format_report(rep)
    assert pflight.analyze_dump(_synth_doc(pflight, [
        (pflight.SPAN_B, "opt.step", 0, 0, 1)])) is None
    for doc in _merge_docs(pflight):
        assert pflight.chrome_events(doc) == jflight.chrome_events(doc)
    merged = pflight.merge_dumps(_merge_docs(pflight))
    assert merged == jflight.merge_dumps(_merge_docs(jflight))
    assert {e["id"] for e in merged if e.get("ph") == "s"} == {42}


def _port_dump_doc():
    r = pflight.recorder()
    with r.span("opt.step", b=1):
        r.instant("mark")
    return pflight.build_dump("unit-test", RuntimeError("boom"))


def test_packed_dumps_readable_both_ways():
    doc = _port_dump_doc()
    assert doc["meta"]["exception"] == "RuntimeError: boom"
    blob = pflight.pack_dump(doc)
    assert blob == jflight.pack_dump(doc)
    assert jflight.unpack_dump(blob) == doc
    jdoc = jflight.build_dump("unit-test")
    assert pflight.unpack_dump(jflight.pack_dump(jdoc)) == jdoc
    assert set(doc) <= set(jdoc)
    assert set(doc["meta"]) == set(jdoc["meta"])
    for bad in (b"XXXX" + blob[4:], b""):
        with pytest.raises(ValueError):
            pflight.unpack_dump(bad)


def _rate_limit_pattern(mod):
    mod.reset_for_job()
    p1 = mod.dump(reason="auto-1", force=False, **(
        {"publish": False} if mod is jflight else {}))
    p2 = mod.dump(reason="auto-2", force=False, **(
        {"publish": False} if mod is jflight else {}))
    p3 = mod.dump(reason="explicit", force=True, **(
        {"publish": False} if mod is jflight else {}))
    with open(p1) as f:
        reason = json.load(f)["meta"]["reason"]
    return p1 is not None, p2 is None, p3 == p1, reason


def test_dump_rate_limit_and_force(monkeypatch):
    for prefix in ("BLUEFOG", "BFT"):
        monkeypatch.setenv(f"{prefix}_FLIGHT_MIN_INTERVAL", "3600")
    want = _rate_limit_pattern(jflight)
    assert want == (True, True, True, "explicit")
    assert _rate_limit_pattern(pflight) == want


def _fatal_names(path):
    with open(path) as f:
        doc = json.load(f)
    return doc, [doc["names"][n] for k, n in zip(doc["events"]["kind"],
                                                 doc["events"]["name"])
                 if k == pflight.INSTANT]


def test_fatal_records_instant_then_dumps(monkeypatch):
    monkeypatch.setenv("BFT_FLIGHT_MIN_INTERVAL", "0")
    pflight.reset_for_job()
    doc, instants = _fatal_names(pflight.fatal("unit", RuntimeError("boom")))
    assert "RuntimeError: boom" in doc["meta"]["exception"]
    assert instants == ["fatal.unit"]


def test_failing_step_dumps_and_reraises(tmp_path):
    model = torch.nn.Linear(3, 1)
    bft.init(device="cpu")
    try:
        opt = bft.DistributedNeighborAllreduceOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), model,
            lambda m, b: (m(b) ** 2).mean())
        opt.step(torch.ones(2, 3))
        with pytest.raises(RuntimeError):
            opt.step(torch.ones(2, 4))           # wrongly shaped batch
        doc, instants = _fatal_names(tmp_path / "bf_flight_0.json")
        assert "fatal.opt.step" in instants
        assert doc["meta"]["reason"] == "opt.step: RuntimeError"
        # the failed step closed its span (step 2, as in JAX) and left
        # the gauge at the last step that returned
        assert pflight.step_report()["step"] == 2
        assert pmetrics.snapshot()["gauges"]["opt.step"] == 1.0
    finally:
        bft.shutdown()


def test_excepthook_chains_and_is_restored(monkeypatch, tmp_path):
    called = []
    prev = lambda *a: called.append(a)  # noqa: E731
    monkeypatch.setattr(sys, "excepthook", prev)
    monkeypatch.setenv("BFT_FLIGHT_MIN_INTERVAL", "0")
    bft.init(device="cpu")
    try:
        # torch.distributed's own hook (installed when the process group
        # forms) is the one the flight hook chains to
        inner = pflight._prev_hook
        assert inner is not None and sys.excepthook is pflight._hook
        pflight.install_excepthook()             # idempotent
        assert sys.excepthook is pflight._hook and pflight._prev_hook is inner
        exc = ValueError("unhandled")
        sys.excepthook(ValueError, exc, None)
        assert called == [(ValueError, exc, None)]
        doc, instants = _fatal_names(tmp_path / "bf_flight_0.json")
        assert "unhandled" in doc["meta"]["exception"]
        assert instants == ["fatal.uncaught"]
    finally:
        bft.shutdown()
    assert sys.excepthook is inner


def test_excepthook_under_another_hook_stays_chained(monkeypatch, tmp_path):
    """A hook installed over the flight hook keeps it in its chain:
    ``shutdown`` leaves both, and the next ``init`` does not wrap the
    flight hook a second time (which would loop)."""
    base = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: base.append(a))
    monkeypatch.setattr(pflight, "_hook_installed", False)
    monkeypatch.setattr(pflight, "_prev_hook", None)
    monkeypatch.setenv("BFT_FLIGHT_MIN_INTERVAL", "0")
    bft.init(device="cpu")
    ours = sys.excepthook
    outer = []

    def hook(*a):
        outer.append(a)
        ours(*a)

    sys.excepthook = hook
    bft.shutdown()
    assert sys.excepthook is hook and pflight._hook_installed
    bft.init(device="cpu")
    bft.shutdown()
    exc = ValueError("late")
    sys.excepthook(ValueError, exc, None)
    assert len(outer) == 1 and base == [(ValueError, exc, None)]
    _, instants = _fatal_names(tmp_path / "bf_flight_0.json")
    assert instants == ["fatal.uncaught"]


@pytest.mark.parametrize("side", list(SIDES))
def test_disable_knob_installs_null_recorder(side, monkeypatch):
    monkeypatch.setenv("BFT_FLIGHT_DISABLE" if side == "port"
                       else "BLUEFOG_FLIGHT_DISABLE", "1")
    mod = SIDES[side][1]
    mod.reset_for_job()
    r = mod.recorder()
    assert not isinstance(r, mod.FlightRecorder)
    r.begin("a")
    r.end("a")
    with r.span("b"):
        pass
    assert r.snapshot()["recorded"] == 0
    assert mod.step_report() is None


def test_record_hot_path_is_cheap():
    r = pflight.FlightRecorder(capacity=4096)
    nid = r.intern("bench")
    n = 20_000
    per = min(timeit.repeat("rec(3, nid)",
                            globals={"rec": r.rec, "nid": nid},
                            number=n, repeat=5)) / n
    assert per < 5e-6, f"ring record costs {per * 1e9:.0f} ns"


# ---------------------------------------------------------------------------
# the optimizer's records and the log prefix
# ---------------------------------------------------------------------------

def _step_records(side):
    mod_m, mod_f = SIDES[side]
    if side == "jax":
        import jax.numpy as jnp
        import optax

        bf.init(devices=cpu_devices(4))
        try:
            opt = bf.DistributedNeighborAllreduceOptimizer(
                optax.sgd(0.1), lambda p, b: jnp.mean((b @ p) ** 2))
            state = opt.init(jnp.zeros((3,)))
            for _ in range(3):
                state, _ = opt.step(state, np.ones((4, 2, 3), np.float32))
            snap = mod_m.snapshot(include_native=False)
            return (snap["gauges"]["opt.step"],
                    snap["hists"]["opt.step_sec"]["count"],
                    mod_f.step_report()["step"])
        finally:
            bf.shutdown()
    bft.init(device="cpu")
    try:
        model = torch.nn.Linear(3, 1)
        opt = bft.DistributedNeighborAllreduceOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), model,
            lambda m, b: (m(b) ** 2).mean())
        for _ in range(3):
            opt.step(torch.ones(2, 3))
        snap = mod_m.snapshot()
        return (snap["gauges"]["opt.step"],
                snap["hists"]["opt.step_sec"]["count"],
                mod_f.step_report()["step"])
    finally:
        bft.shutdown()


def test_optimizer_step_records_equal_jax():
    assert _step_records("port") == _step_records("jax") == (3.0, 3, 3)


def test_log_records_carry_rank_prefix():
    from bluefog_tpu.runtime.logging import _RankPrefixFilter as JaxFilter
    from bluefog_tpu_torch.runtime.logging import _RankPrefixFilter, logger

    assert _RankPrefixFilter._prefix() == ""
    bf.init(devices=cpu_devices(4))
    bft.init(device="cpu")
    try:
        assert _RankPrefixFilter._prefix() == JaxFilter._prefix() == \
            "[rank 0 / inc 0] "
        (handler,) = logger.handlers
        rec = logging.LogRecord("bluefog_tpu_torch", logging.WARNING,
                                __file__, 1, "msg", (), None)
        assert handler.filter(rec)
        assert handler.format(rec).endswith("[WARNING] [rank 0 / inc 0] msg")
        assert not logger.propagate
    finally:
        bft.shutdown()
        bf.shutdown()
    assert _RankPrefixFilter._prefix() == ""
