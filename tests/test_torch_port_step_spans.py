"""The port's spans inside its training step, on the CPU.

A world-2 gloo job (``tests/_torch_port_child.py``, mode ``step_spans``,
one rank a machine) steps each fused optimizer kind once under a profiler
started directly, as a benchmark's recorder starts it
(``profiled_ranges``): the step's spans, ``<name>.<PHASE>`` ranges on the
step's thread, come in the kind's order and nest inside ``STEP`` (the
combine's parts inside ``COMBINE``). One untraced step after it grew
``opt.combine_bytes`` by the flat buffer's bytes times the plan's shift
count, and ``opt.plan_builds`` not at all (the plan is cached); the fullest
``bf.step_report()`` of it and four more (the suite shares its cores)
covers at least 90 % of ``step_sec`` with every phase of the combine
nonzero.

In process, at world 1: with the profiler and the timeline off, a step
enters no ``record_function`` of its own (torch.optim's are its own);
``_profiler_mark`` fires under a profiler started directly; a span's start
in the timeline file and in the profiler's events agree within 1 ms.
"""

import json

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bft
from bluefog_tpu_torch.runtime import timeline as ptimeline
from _torch_port_child import SPAN_KINDS, profiled_ranges, run_world

COMBINE = ["COMBINE", "PACK", "EXCHANGE", "SUM", "UNPACK", "WRITE_BACK"]
ORDER = {
    "DistributedGradientAllreduceOptimizer":
        ["STEP", "FORWARD", "BACKWARD", "ALLREDUCE", "UPDATE"],
    "DistributedAllreduceOptimizer":
        ["STEP", "FORWARD", "BACKWARD", "UPDATE", "ALLREDUCE", "WRITE_BACK"],
    "DistributedNeighborAllreduceOptimizer":
        ["STEP", "FORWARD", "BACKWARD", "UPDATE"] + COMBINE,
    "DistributedHierarchicalNeighborAllreduceOptimizer":
        ["STEP", "FORWARD", "BACKWARD", "UPDATE"] + COMBINE,
    "DistributedShardedAllreduceOptimizer":
        ["STEP", "FORWARD", "BACKWARD", "REDUCE_SCATTER", "UPDATE",
         "ALL_GATHER"],
}
PARENT = {"PACK": "COMBINE", "EXCHANGE": "COMBINE", "SUM": "COMBINE",
          "UNPACK": "COMBINE"}
COMBINING = ["DistributedNeighborAllreduceOptimizer",
             "DistributedHierarchicalNeighborAllreduceOptimizer"]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_port_step_spans")
    x = np.random.default_rng(3).standard_normal((2, 64, 32))
    np.savez(d / "inputs.npz", x=x.astype(np.float32), local_size=1)
    return run_world("step_spans", str(d), world=2, timeout=240)


@pytest.mark.parametrize("kind", SPAN_KINDS)
def test_spans_nest_in_the_kinds_order(world2, kind):
    assert list(ORDER) == list(SPAN_KINDS)
    for out in world2:
        names = [str(n) for n in out[f"{kind}:names"]]
        assert names == ORDER[kind]
        at = dict(zip(names, out[f"{kind}:spans"].tolist()))
        step = at["STEP"]
        for name, (a, b) in at.items():
            outer = at[PARENT.get(name, "STEP")]
            assert outer[0] <= a <= b <= outer[1], (name, at)
        # siblings follow one another
        for outer in ("STEP", "COMBINE"):
            kids = [at[n] for n in names if n != "STEP"
                    and PARENT.get(n, "STEP") == outer]
            assert all(p[1] <= q[0] for p, q in zip(kids, kids[1:]))
        assert step[1] > step[0]


@pytest.mark.parametrize("kind", COMBINING)
def test_step_report_covers_the_fused_step(world2, kind):
    for out in world2:
        assert float(out[f"{kind}:coverage"]) >= 0.9
        assert all(out[f"{kind}:phases"] > 0), out[f"{kind}:phases"]


@pytest.mark.parametrize("kind", COMBINING)
def test_combine_bytes_are_the_flat_buffer_per_shift(world2, kind):
    for out in world2:
        shifts = int(out[f"{kind}:shifts"])
        assert shifts == 1
        assert int(out[f"{kind}:sends"]) == shifts
        assert int(out[f"{kind}:bytes"]) == \
            int(out[f"{kind}:flat_bytes"]) * shifts
        assert int(out[f"{kind}:plan_builds"]) == 0


# ---------------------------------------------------------------------------
# in process, at world 1
# ---------------------------------------------------------------------------

@pytest.fixture()
def world1(tmp_path, monkeypatch):
    monkeypatch.setenv("BFT_FLIGHT_DIR", str(tmp_path))
    bft.init(device="cpu")
    yield
    bft.shutdown()


@pytest.fixture()
def entered(monkeypatch):
    """The names of every ``record_function`` entered."""
    names = []
    cls = torch.autograd.profiler.record_function
    enter = cls.__enter__

    def counting(self):
        names.append(self.name)
        return enter(self)
    monkeypatch.setattr(cls, "__enter__", counting)
    return names


@pytest.mark.parametrize("kind", SPAN_KINDS)
def test_off_path_enters_no_record_function(world1, entered, kind):
    model = torch.nn.Linear(3, 1)
    opt = getattr(bft, kind)(torch.optim.SGD(model.parameters(), lr=0.1),
                             model, lambda m, b: (m(b) ** 2).mean())
    opt.step(torch.ones(2, 3))
    assert not torch.autograd._profiler_enabled()
    assert all(n.startswith("Optimizer.") for n in entered), entered
    # the patch sees the program's spans once a profiler runs
    profiled_ranges(lambda: opt.step(torch.ones(2, 3)))
    assert f"{kind}.STEP" in entered and f"{kind}.UPDATE" in entered


def test_profiler_mark_under_a_profiler_started_directly(world1):
    ranges, _ = profiled_ranges(
        lambda: ptimeline.timeline_flow_start("mark", 7))
    assert "mark.s.7" in ranges


def test_timeline_and_profiler_on_one_clock(world1, tmp_path):
    def spans():
        for _ in range(3):
            with bft.timeline_context("clock", "SPAN"):
                pass

    prefix = str(tmp_path / "clock_")
    assert bft.start_timeline(prefix)
    try:
        ranges, _ = profiled_ranges(spans)
    finally:
        bft.stop_timeline()
    with open(prefix + "0.json") as f:
        events = json.load(f)
    anchor = events[0]
    assert anchor["name"] == ptimeline.CLOCK_SYNC_COUNTER
    wall = anchor["args"]["value"] - anchor["ts"]
    starts = [wall + e["ts"] for e in events
              if e.get("ph") == "B" and e.get("cat") == "clock"]
    profiled = [a / 1e3 for a, _, _ in ranges["clock.SPAN"]]
    assert len(starts) == len(profiled) == 3
    for t_timeline, t_profiler in zip(starts, profiled):
        assert abs(t_timeline - t_profiler) < 1000.0, (t_timeline,
                                                       t_profiler)
