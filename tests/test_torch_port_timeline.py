"""Port vs JAX: the chrome-tracing timeline.

A world-4 gloo job (``tests/_torch_port_child.py``, mode ``timeline``) runs
``allreduce``, ``broadcast``, ``allgather``, ``neighbor_allreduce`` (static,
then one dynamic plan twice), ``pair_gossip``, one nonblocking allreduce
through ``synchronize``, a ``timeline_context`` and 3 steps of
``DistributedNeighborAllreduceOptimizer`` with ``BFT_TIMELINE`` set, so
``bf.init`` opens the trace. The JAX package runs the same calls on 4 CPU
devices under its own ``Timeline``. Every rank's file must be valid chrome
JSON that starts with the clock anchor, balance its spans per lane, close
its ``COMMUNICATE`` spans, tag ``PLAN_BUILD`` with the first dynamic call
only, and hold the same set of ``(ph, name, cat)`` as JAX's trace, with
the spans of the fused step's parts and the combine's counters besides.
``scripts/merge_timelines.py`` then lays the four files on one clock: no
rank's ``COMMUNICATE`` of the blocking allreduce may end before the last
rank issued it. Each rank's log prefix names its rank.

In process, at world 1: ``start_timeline``/``stop_timeline`` toggle the
trace, a writer that cannot open its file stops producing, and
``timeline_context`` names a ``torch.profiler`` range.
"""

import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu.runtime.state import _global_state as _jax_state
from bluefog_tpu.runtime.timeline import Timeline as JaxTimeline
from bluefog_tpu_torch.runtime.state import _global_state
from bluefog_tpu_torch.runtime.timeline import Timeline
from conftest import cpu_devices
from _torch_port_child import run_world, timeline_ops

N = 4
# the wall-clock anchors of two processes on one host come from one clock;
# what separates them is the gap between the anchor's two clock reads
MERGE_SLACK_US = 1000.0


def _events(path):
    with open(path) as f:
        return json.load(f)


def _signature(events) -> set:
    return {(e.get("ph"), e.get("name"), e.get("cat")) for e in events}


def _check_balanced(events) -> None:
    open_spans = {}
    for e in events:
        key = (e.get("cat"), e.get("tid"))
        if e.get("ph") == "B":
            open_spans[key] = open_spans.get(key, 0) + 1
        elif e.get("ph") == "E":
            open_spans[key] = open_spans.get(key, 0) - 1
            assert open_spans[key] >= 0, f"E without B for {key}"
    assert all(v == 0 for v in open_spans.values()), open_spans


def _inputs() -> dict:
    return {"x": np.random.default_rng(7).standard_normal((N, 2, 3)).astype(
        np.float32)}


def _jax_trace(tmp_path) -> list:
    import jax.numpy as jnp
    import optax

    x = _inputs()["x"]
    bf.init(devices=cpu_devices(N))
    st = _jax_state()
    st.timeline = JaxTimeline(str(tmp_path / "jax_tl_"), use_native=False)

    def make_opt():
        def loss(p, b):
            return jnp.mean((b @ p["w"] + p["b"]) ** 2)

        opt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.1), loss)
        state = [opt.init({"w": jnp.zeros((3, 1)), "b": jnp.zeros((1,))})]

        def step():
            state[0], _ = opt.step(state[0], x)
        return opt, step

    try:
        timeline_ops(bf, x, N, make_opt)
    finally:
        path = st.timeline.path
        bf.shutdown()
    return _events(path)


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_port_timeline")
    np.savez(d / "inputs.npz", **_inputs())
    prefix = str(d / "tl_")
    env = {"BFT_TIMELINE": prefix, "BFT_FLIGHT_DIR": str(d)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        outs = run_world("timeline", str(d), world=N, timeout=120)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    jax_events = _jax_trace(d)
    paths = [f"{prefix}{r}.json" for r in range(N)]
    return {"outs": outs, "paths": paths,
            "port": [_events(p) for p in paths], "jax": jax_events}


def test_env_knob_opens_one_file_per_rank(traces):
    for r, (out, events) in enumerate(zip(traces["outs"], traces["port"])):
        assert bool(out["timeline_on"]) and int(out["step"]) == 3
        assert str(out["log_prefix"]) == f"[rank {r} / inc 0] "
        assert events[0]["name"] == "bf.clock_sync_us"
        assert events[0]["ph"] == "C" and events[0]["args"]["value"] > 0
        assert {e["pid"] for e in events} == {r}


# what the port's timeline holds beyond the JAX package's: the spans of
# the fused step's parts, the combine's and the update's counter tracks
PORT_ONLY = {("B", part, "DistributedNeighborAllreduceOptimizer")
             for part in ("FORWARD", "BACKWARD", "UPDATE", "COMBINE", "PACK",
                          "EXCHANGE", "SUM", "UNPACK", "WRITE_BACK")} | \
    {("C", name, "bf") for name in ("opt.combine_bytes", "opt.combine_sends",
                                     "opt.plan_builds", "opt.update_fused")}


def test_same_events_as_jax(traces):
    want = _signature(traces["jax"])
    assert ("B", "STEP", "DistributedNeighborAllreduceOptimizer") in want
    assert not want & PORT_ONLY
    for r, events in enumerate(traces["port"]):
        got = _signature(events)
        assert got == want | PORT_ONLY, (
            f"rank {r}: port only {sorted(got - want - PORT_ONLY)}, "
            f"JAX only {sorted(want - got)}, missing "
            f"{sorted(PORT_ONLY - got)}")


@pytest.mark.parametrize("side", ["port", "jax"])
def test_spans_balance_and_communicate_closes(traces, side):
    runs = traces["port"] if side == "port" else [traces["jax"]]
    for events in runs:
        _check_balanced(events)
        comm = [e for e in events if e.get("name") == "COMMUNICATE"]
        assert comm and all(e["tid"] >= 1000 for e in comm)
        lanes = {(e["cat"], e["tid"]) for e in comm}
        ends = [e for e in events if e.get("ph") == "E"
                and (e["cat"], e["tid"]) in lanes]
        assert len(ends) == len(comm)
        steps = [e for e in events if e.get("name") == "STEP"]
        assert len(steps) == 3


def test_plan_build_on_first_dynamic_call_only(traces):
    for events in traces["port"] + [traces["jax"]]:
        builds = {e["cat"] for e in events
                  if e.get("ph") == "B" and e.get("name") == "PLAN_BUILD"}
        assert builds == {"tl.nar.static", "tl.nar.dyn"}


def _merge_mod():
    scripts = os.path.join(os.path.dirname(__file__), "..", "scripts")
    sys.path.insert(0, scripts)
    try:
        return importlib.import_module("merge_timelines")
    finally:
        sys.path.pop(0)


def test_merge_timelines_lays_ranks_on_one_clock(traces):
    merged = _merge_mod().merge(traces["paths"])
    assert {e["pid"] for e in merged if e.get("ph") == "M"} == set(range(N))
    issued, done = [], []
    for r in range(N):
        mine = [e for e in merged if e.get("pid") == r
                and e.get("cat") == "tl.allreduce"]
        issued.append(max(e["ts"] for e in mine
                          if e.get("name") == "ALLREDUCE"))
        done.append(min(e["ts"] for e in mine if e.get("ph") == "E"
                        and e["tid"] >= 1000))
    # an all-reduce completes on no rank before every rank has issued it
    assert max(issued) <= min(done) + MERGE_SLACK_US, (issued, done)


@pytest.fixture()
def world1(tmp_path, monkeypatch):
    monkeypatch.setenv("BFT_FLIGHT_DIR", str(tmp_path))
    bft.init(device="cpu")
    yield
    bft.shutdown()


def test_start_stop_timeline_runtime_toggle(world1, tmp_path):
    prefix = str(tmp_path / "toggle_")
    assert bft.start_timeline(prefix)
    assert not bft.start_timeline(prefix)  # double start refused
    x = torch.ones(2)
    bft.allreduce(x, name="toggle.t")
    assert bft.timeline_start_activity("w.0", "COMPUTE")
    assert bft.timeline_end_activity("w.0")
    path = _global_state().timeline.path
    assert bft.stop_timeline()
    assert not bft.stop_timeline()  # double stop refused
    events = _events(path)
    assert path == prefix + "0.json"
    assert any(e.get("name") == "ALLREDUCE" and e["cat"] == "toggle.t"
               for e in events)
    assert any(e.get("name") == "COMPUTE" and e["cat"] == "w.0"
               for e in events)
    _check_balanced(events)
    # ops after the stop neither fail nor write
    bft.allreduce(x, name="toggle.after")
    assert not bft.timeline_start_activity("w.1", "COMPUTE")
    assert _events(path) == events


def test_failed_writer_stops_producing(tmp_path):
    tl = Timeline(str(tmp_path / "missing_dir" / "tl_"), process_index=0)
    tl._writer.join(timeout=5.0)
    assert tl._failed
    queued = tl._q.qsize()        # the clock anchor, put before the failure
    tl.activity_start("x", "Y")
    assert tl._q.qsize() == queued
    tl.close()


def test_timeline_context_names_a_profiler_range(world1):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with bft.timeline_context("prof.t", "STEP"):
            torch.ones(4).sum()
    assert any(e.name == "prof.t.STEP" for e in prof.events())
