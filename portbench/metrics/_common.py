"""Readings that several metrics share; each metric's own file names
which it reads."""

from __future__ import annotations

from portbench import harness, tracing
from portbench.counts.peaks import H100_BF16_FLOPS


def rate(run, unit: str):
    """Items of ``unit`` a second over the whole window."""
    if run.cell.job["inputs"]["kind"] != unit:
        return None
    return run.items_per_step * run.steps / run.window_s


def p95_ms(run):
    return harness.percentile(run.step_ms, 95)


def mfu(run, flops_per_step: float):
    """The step's model FLOPs a second over the bf16 peak, in %."""
    return 100.0 * flops_per_step * run.steps / run.window_s / H100_BF16_FLOPS


def range_ms(run, name: str):
    """Device ms a step of the activities launched inside range ``name``."""
    if run.trace is None:
        return None
    total = run.trace.range_device_s(name)
    return None if total is None else 1e3 * total / run.steps


def update_ms(run):
    return range_ms(run, tracing.UPDATE)


def combine_ms(run):
    return range_ms(run, tracing.COMBINE)


def device_idle(run):
    """The share of the traced window in which nothing ran on the card, %
    (busy seconds and window each the mean over the ranks)."""
    if run.busy_s is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.traced_s)


def peak_mem_gib(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30
