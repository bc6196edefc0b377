"""The trace reader on a made-up window: busy time as a union of
intervals, the device time of the kernels launched inside a range, the
idle gaps by the step's part and the runtime call that launched the
activity ending each."""

from __future__ import annotations

import pytest
from torch.autograd import DeviceType

from portbench import tracing


class Ev:
    def __init__(self, name, device, start, dur, corr=0, tid=1,
                 annotation=False):
        self._v = (name, device, start, dur, corr, tid, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


@pytest.fixture
def trace():
    events = [
        Ev(tracing.WINDOW, CPU, 0, 1000, annotation=True),
        Ev(tracing.FORWARD, CPU, 5, 20, annotation=True),
        Ev(tracing.UPDATE, CPU, 100, 100, annotation=True),
        Ev(tracing.UPDATE, CUDA, 300, 200, tid=7, annotation=True),  # mirror
        # the launches: in the forward range, in the update range, on the
        # autograd engine's thread (2), and on the window's thread outside
        # the ranges
        Ev("cudaLaunchKernel", CPU, 11, 1, corr=11),
        Ev("cudaLaunchKernel", CPU, 151, 1, corr=12),
        Ev("cudaMemcpyAsync", CPU, 601, 1, corr=13, tid=2),
        Ev("cudaMemsetAsync", CPU, 840, 1, corr=14),
        # listed out of time order, one overlapping another
        Ev("flash_fwd_kernel<128>", CUDA, 300, 200, corr=12, tid=7),
        Ev("gemm", CUDA, 50, 150, corr=11, tid=7),
        Ev("Memcpy DtoD", CUDA, 700, 100, corr=13, tid=7),
        Ev("Memset", CUDA, 850, 50, corr=14, tid=7),
        Ev("Context Sync", CUDA, 0, 1000, tid=7),
    ]
    return tracing.Trace(events)


def test_window_and_busy_time(trace):
    assert trace.window_s == pytest.approx(1000e-9)
    # [50, 200) + [300, 500) + [700, 800) + [850, 900): the sync record is
    # not activity
    assert trace.busy_s() == pytest.approx(500e-9)


def test_kernel_and_range_time(trace):
    assert trace.kernel_s("flash_fwd") == (pytest.approx(200e-9), 1)
    assert trace.range_device_s(tracing.UPDATE) == pytest.approx(200e-9)
    assert trace.range_device_s(tracing.COMBINE) is None


def test_breakdown(trace):
    b = trace.breakdown()
    assert b["device_ops"][0] == ["flash_fwd_kernel<128>", pytest.approx(200e-9)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps[f"{tracing.FORWARD}/cudaLaunchKernel"] == pytest.approx(50e-9)
    assert gaps[f"{tracing.UPDATE}/cudaLaunchKernel"] == pytest.approx(100e-9)
    assert gaps[f"{tracing.BACKWARD}/cudaMemcpyAsync"] == pytest.approx(200e-9)
    assert gaps[f"{tracing.WINDOW}/cudaMemsetAsync"] == pytest.approx(50e-9)
    assert gaps["after the last activity"] == pytest.approx(100e-9)
