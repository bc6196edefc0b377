"""The readers of the program's own spans on a made-up window: the device
time of the kernels launched inside a phase's span, by time whatever the
launching thread, and the time the host spends inside a span while the
card is idle; a program without the spans (a parent commit) gives None."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import tracing
from portbench.spec import Spec
from portbench.tests.test_portbench_tracing import CPU, CUDA, Ev

STEPS = 2
OPT = "DistributedNeighborAllreduceOptimizer"


def _trace(program_spans: bool) -> tracing.Trace:
    events = [
        Ev(tracing.WINDOW, CPU, 0, 1000, annotation=True),
        Ev(tracing.UPDATE, CPU, 100, 100, annotation=True),
        # the launches: in the update, in the combine on the step's thread
        # and on another (2), and after both spans
        Ev("cudaLaunchKernel", CPU, 150, 1, corr=1),
        Ev("cudaLaunchKernel", CPU, 310, 1, corr=2),
        Ev("cudaLaunchKernel", CPU, 400, 1, corr=3, tid=2),
        Ev("cudaLaunchKernel", CPU, 700, 1, corr=4),
        Ev("elementwise", CUDA, 150, 100, corr=1, tid=7),
        Ev("ncclDevKernel_SendRecv", CUDA, 320, 100, corr=2, tid=7),
        Ev("elementwise", CUDA, 450, 30, corr=3, tid=7),
        Ev("elementwise", CUDA, 800, 100, corr=4, tid=7),
    ]
    if program_spans:
        events += [
            Ev(f"{OPT}.UPDATE", CPU, 100, 100, annotation=True),
            Ev(f"{OPT}.COMBINE", CPU, 300, 300, annotation=True),
            Ev(f"{OPT}.EXCHANGE", CPU, 305, 100, annotation=True),
            # a span of the phase on another thread is not the step's
            Ev(f"{OPT}.COMBINE", CPU, 750, 100, tid=2, annotation=True),
        ]
    return tracing.Trace(events)


def _run(program_spans: bool = True):
    return SimpleNamespace(trace=_trace(program_spans), steps=STEPS)


@pytest.mark.parametrize("name, want_ns", [
    ("span_update_ms.lm", 100), ("span_update_ms.vision", 100),
    ("span_combine_ms.lm", 130), ("span_combine_ms.vision", 130),
    # [300, 600) less the card's [320, 420) and [450, 480)
    ("combine_idle_ms.lm", 170),
])
def test_span_metrics(name, want_ns):
    read = Spec().reader(name)
    assert read(_run()) == pytest.approx(want_ns / 1e6 / STEPS)
    assert read(_run(program_spans=False)) is None
    assert read(SimpleNamespace(trace=None, steps=STEPS)) is None


def test_the_span_and_the_harness_range_read_alike():
    run = _run()
    assert Spec().reader("span_update_ms.lm")(run) == \
        pytest.approx(Spec().reader("update_ms.lm")(run))


def test_activities_by_name_inside_a_span():
    from portbench.metrics._spans import intervals, launched_ms

    run = _run()
    assert intervals(run.trace, "COMBINE") == [(300, 600)]
    assert launched_ms(run, "EXCHANGE", "nccl") == pytest.approx(100e-6 / 2)
    assert launched_ms(run, "COMBINE", "nccl") == pytest.approx(100e-6 / 2)
    assert intervals(run.trace, "SUM") is None
