"""The traced window: device activity from ``torch.profiler``, read once.

The harness opens the ranges it reads (``portbench.window`` around the
window; ``portbench.forward``, ``portbench.update`` and ``portbench.combine``
around the step's parts) with ``record_function``. ``Recorder`` traces the
card's activity and the runtime calls that launch it, and on the host only
those ranges: no aten op is recorded, so the profiler adds almost nothing
to the host's issue of a step. This module reads the raw events once into
plain lists:

  * device activity: every kernel, copy and set on the card, without the
    annotations mirrored onto the device timeline and the sync records;
  * the host's launch of each: the runtime call with the same correlation
    id, its time and thread;
  * the ranges, by name.

A kernel belongs to a range when its launch lies inside one of the range's
intervals on the same thread. Launches on another thread than the
window's are the autograd engine's: the backward pass.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from torch.autograd import DeviceType

WINDOW = "portbench.window"
FORWARD = "portbench.forward"
UPDATE = "portbench.update"
COMBINE = "portbench.combine"
BACKWARD = "backward thread"
_NOT_ACTIVITY = {"Context Sync", "Stream Sync", "Event Sync", "Device Sync",
                 "Stream Wait Event"}


class Recorder:
    """``torch.profiler``'s recorder over the window, with the host side cut
    to the ``record_function`` ranges (the user scope)."""

    def __init__(self, cuda: bool) -> None:
        from torch.autograd import profiler
        self._prof = profiler.profile(use_device="cuda" if cuda else None,
                                      use_kineto=True)

    def start(self) -> None:
        from torch._C._autograd import _enable_profiler
        from torch._C._profiler import RecordScope
        self._prof._prepare_trace()
        try:
            config = self._prof.config(create_trace_id=False)
        except TypeError:
            config = self._prof.config()
        _enable_profiler(config, self._prof.kineto_activities,
                         {RecordScope.USER_SCOPE})

    def stop(self) -> "Trace":
        from torch._C._autograd import _disable_profiler
        return Trace(_disable_profiler().events())


class Trace:
    """``events``: the profiler's raw events,
    ``prof.profiler.kineto_results.events()``."""

    def __init__(self, events) -> None:
        self.device: List[Tuple[str, int, int, int]] = []  # name, t0, t1, corr
        self.launch: Dict[int, Tuple[int, int, str]] = {}  # corr -> t, tid, call
        ranges = defaultdict(list)
        for e in events:
            name = e.name()
            start = e.start_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation() and name not in _NOT_ACTIVITY:
                    self.device.append((name, start, start + e.duration_ns(),
                                        e.correlation_id()))
            elif e.is_user_annotation():
                ranges[name].append((start, start + e.duration_ns(),
                                     e.device_resource_id()))
            elif name.startswith("cu"):
                self.launch[e.correlation_id()] = (
                    start, e.device_resource_id(), name)
        self.ranges = {k: sorted(v) for k, v in ranges.items()}
        self._starts = {k: [a for a, _, _ in v] for k, v in self.ranges.items()}
        if WINDOW not in self.ranges:
            raise RuntimeError("the trace holds no portbench.window range")
        self.t0, self.t1, self.tid = self.ranges[WINDOW][0]
        self.device = sorted((e for e in self.device
                              if e[2] > self.t0 and e[1] < self.t1),
                             key=lambda e: e[1])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _clipped(self):
        for name, a, b, corr in self.device:
            yield name, max(a, self.t0), min(b, self.t1), corr

    def busy_s(self) -> float:
        """Seconds of the window in which any device activity ran."""
        busy, end = 0, self.t0
        for _, a, b, _ in self._clipped():
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e9

    def kernel_s(self, part: str) -> Tuple[float, int]:
        """Device seconds and count of the activities whose name holds
        ``part``."""
        found = [b - a for name, a, b, _ in self._clipped() if part in name]
        return sum(found) / 1e9, len(found)

    def _in_range(self, name: str, t: int, tid: int) -> bool:
        spans = self.ranges.get(name, ())
        i = bisect.bisect_right(self._starts[name], t) - 1 if spans else -1
        return i >= 0 and spans[i][1] >= t and spans[i][2] == tid

    def range_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the activities launched inside ``name``, or
        None where the window holds no such range."""
        if name not in self.ranges:
            return None
        total = 0
        for _, a, b, corr in self._clipped():
            at = self.launch.get(corr)
            if at is not None and self._in_range(name, at[0], at[1]):
                total += b - a
        return total / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing when it launched the activity that
        ends each: the step's part and the runtime call."""
        ops = defaultdict(int)
        for name, a, b, _ in self._clipped():
            ops[name[:160]] += b - a
        gaps = defaultdict(int)
        end = self.t0
        for name, a, b, corr in self._clipped():
            if a > end:
                gaps[self._launcher(corr)] += a - end
            end = max(end, b)
        if self.t1 > end:
            gaps["after the last activity"] += self.t1 - end

        def best(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(gaps)}

    def _launcher(self, corr: int) -> str:
        at = self.launch.get(corr)
        if at is None:
            return "unattributed"
        t, tid, call = at
        if tid != self.tid:
            return f"{BACKWARD}/{call}"
        part = next((rng for rng in (FORWARD, UPDATE, COMBINE)
                     if self._in_range(rng, t, tid)), WINDOW)
        return f"{part}/{call}"
