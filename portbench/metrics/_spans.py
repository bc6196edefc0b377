"""The program's own spans in the traced window, found by their phase.

The port's optimizer opens a ``record_function`` range for each part of its
step, named ``<optimizer>.<PHASE>`` (``UPDATE``, ``COMBINE``, ``EXCHANGE``,
...; ``bluefog_tpu_torch/runtime/timeline.py``), on the thread that calls
``step()``. A program without them (a parent commit that predates them)
leaves every reading here None, and the metric out of the line.

A kernel belongs to a span when its launch lies, by time, inside one of the
span's intervals, whatever thread launched it: the backward pass launches
from the autograd engine's thread while the step's thread waits inside its
span.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple


def intervals(trace, phase: str) -> Optional[List[Tuple[int, int]]]:
    """The host intervals of the program's ``<name>.<phase>`` spans on the
    window's thread, clipped to the window and sorted; None where the
    window holds none."""
    suffix = "." + phase
    found = [(max(a, trace.t0), min(b, trace.t1))
             for name, spans in trace.ranges.items()
             if name.endswith(suffix) and not name.startswith("portbench.")
             for a, b, tid in spans
             if tid == trace.tid and b > trace.t0 and a < trace.t1]
    return sorted(found) or None


def _device(trace):
    """Each device activity, clipped to the window, in order of start."""
    for name, a, b, corr in trace.device:
        yield name, max(a, trace.t0), min(b, trace.t1), corr


def launched_ms(run, phase: str, part: str = "") -> Optional[float]:
    """Device ms a step of the activities (those whose name holds ``part``)
    launched inside the spans of ``phase``."""
    trace = run.trace
    spans = None if trace is None else intervals(trace, phase)
    if spans is None:
        return None
    starts = [a for a, _ in spans]
    total = 0
    for name, a, b, corr in _device(trace):
        at = trace.launch.get(corr)
        if part not in name or at is None:
            continue
        i = bisect.bisect_right(starts, at[0]) - 1
        if i >= 0 and spans[i][1] >= at[0]:
            total += b - a
    return total / 1e6 / run.steps


def idle_ms(run, phase: str) -> Optional[float]:
    """Ms a step in which the host is inside a span of ``phase`` and nothing
    runs on the card: the spans' intervals less the union of the device's."""
    trace = run.trace
    spans = None if trace is None else intervals(trace, phase)
    if spans is None:
        return None
    busy: List[List[int]] = []
    for _, a, b, _ in _device(trace):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        elif b > a:
            busy.append([a, b])
    idle, j = 0, 0
    for a, b in spans:
        idle += b - a
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            idle -= min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return idle / 1e6 / run.steps
