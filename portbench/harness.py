"""One run of one cell: set-up, the timed window, the output check.

Set-up builds the port's training step once (``builders/``), loads the
weights drawn from the seed, and drives that same object through its first
three steps on the first three batches of the pool, reading what the output
check compares. It then steps on until the caching allocator stops growing.

The window calls ``DistributedNeighborAllreduceOptimizer.step(batch)`` on the
pool in turn, records a CUDA event after each step and never waits on the
card; once the host clock passes ``seconds`` one ``synchronize`` closes it.
Step times are the intervals between the events; rates are all the window's
work over the device time from its first event to its last.

Once the window has closed and the peak memory is read, the program is
freed and the reference (``reference/``) trains from the same seed.

In a cell of more than one rank each rank runs this in its own process
(``world.launch``); the ranks agree on the host when warm-up and the window
end, and rank 0's result holds every rank's readings.
"""

from __future__ import annotations

import gc
import importlib
import itertools
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from . import check, data, tracing, weights, world
from .builders import first_gradient
from .spec import Cell, Spec

FAULTS = ("unchanged", "half_batch")
WORLD_FAULTS = ("no_exchange",)        # faults that need more than one rank
_WARM_MAX = 8


@dataclass
class RunInfo:
    """What a metric's reader reads."""

    cell: Cell
    steps: int                       # steps in the window
    step_ms: List[float]             # each step's device time
    window_s: float                  # first event to last, device clock
    setup_s: float                   # process start to the window's start
    items_per_step: int              # tokens or images of all ranks a step
    peak_window_bytes: int           # the fullest card's peak in the window
    trace: Optional[tracing.Trace]   # rank 0's traced window, with --trace 1
    busy_s: Optional[float] = None   # the traced windows' busy seconds and
    traced_s: Optional[float] = None  # lengths, each the mean over the ranks


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between the closest ranks."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class _Clock:
    """CUDA events on the card; the host clock, after each step, on the CPU
    (where every operation has finished when it returns)."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def intervals_ms(self, marks) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


def modules(builder: str):
    return (importlib.import_module(f"portbench.builders.{builder}"),
            importlib.import_module(f"portbench.reference.{builder}"))


def plant(job, faults: Sequence[str]) -> None:
    """Break the timed path underneath, for the tests and the calibration:
    ``unchanged``, a step that leaves the parameters as they were;
    ``half_batch``, a loss over the first half of each batch;
    ``no_exchange``, a combine that leaves each rank's parameters its own."""
    for fault in faults:
        if fault == "unchanged":
            job.opt.base.step = lambda *a, **k: None
        elif fault == "no_exchange":
            job.opt._combine = lambda tensors, plan: tensors
        elif fault == "half_batch":
            loss = job.opt.loss_fn
            job.opt.loss_fn = lambda model, batch: loss(
                model, tuple(t[: t.shape[0] // 2] for t in batch))
        else:
            raise ValueError(f"unknown fault {fault!r} "
                             f"(have {FAULTS + WORLD_FAULTS})")


def program_readings(job, batches, specs, cell: Cell, seed: int,
                     device: torch.device) -> dict:
    """The first three steps of the built step, as the check reads them."""
    opt, spec = job.opt, cell.job["optimizer"]
    losses = [opt.step(batches[0])["loss"]]
    grad = check.leaf_norms((n, first_gradient(opt.base, p, spec))
                            for n, p in job.leaves)
    for batch in batches[1:3]:
        losses.append(opt.step(batch)["loss"])
    start = weights.generate(specs, seed, device)
    change = check.leaf_norms((n, p.detach() - start[n]) for n, p in job.leaves)
    return {"loss": [float(x) for x in losses], "grad": grad, "change": change,
            "weights": [n for n, p in job.leaves if p.dim() >= 2]}


def _agree(flag: bool) -> bool:
    return flag if world.size() == 1 else world.any_rank(flag)


def _warm_up(job, feed, device: torch.device) -> int:
    """Step until the caching allocator holds as much after a step as
    before it (at least two steps) on every rank; the number of steps."""
    held = None
    for n in range(1, _WARM_MAX + 1):
        job.opt.step(next(feed))
        if device.type != "cuda":
            growing = False
        else:
            torch.cuda.synchronize()
            now = torch.cuda.memory_reserved()
            growing, held = now != held, now
        if not _agree(growing):
            break
    return n


def _open_ranges(opt) -> None:
    """Ranges around the forward pass, the update and the combine of this
    optimizer instance: instance attributes wrap the loss and the bound
    methods, the program is unchanged."""
    loss, update, combine = opt.loss_fn, opt.base.step, opt._combine

    def ranged_loss(*a, **k):
        with record_function(tracing.FORWARD):
            return loss(*a, **k)

    def ranged_update(*a, **k):
        with record_function(tracing.UPDATE):
            return update(*a, **k)

    def ranged_combine(*a, **k):
        with record_function(tracing.COMBINE):
            return combine(*a, **k)
    opt.loss_fn = ranged_loss
    opt.base.step = ranged_update
    opt._combine = ranged_combine


def _window(opt, feed, seconds: float, clock: _Clock):
    losses, marks = [], [clock.mark()]
    deadline = time.perf_counter() + seconds
    while True:
        losses.append(opt.step(next(feed))["loss"])
        marks.append(clock.mark())
        if _agree(time.perf_counter() >= deadline):
            break
    clock.sync()
    return losses, marks


def _gather(mine) -> list:
    return [mine] if world.size() == 1 else world.gather(mine)


def _mean(ranks: list, key: str) -> Optional[float]:
    values = [r[key] for r in ranks]
    return None if values[0] is None else sum(values) / len(values)


def _worst(ranks: List[dict]) -> dict:
    """Each number's largest reading over the ranks, beside its limit."""
    return {name: {"value": max(r[name]["value"] for r in ranks),
                   "limit": c["limit"]} for name, c in ranks[0].items()}


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t0: Optional[float] = None,
        root: Optional[str] = None,
        faults: Sequence[str] = ()) -> Tuple[dict, dict]:
    """One run: the result line as a dict (``checks`` last), and the
    seconds of its set-up, its parts, the window and the reference."""
    t0 = time.perf_counter() if t0 is None else t0
    marks = {"start_s": time.perf_counter() - t0}

    def mark(part: str) -> None:
        marks[part] = time.perf_counter() - t0
    spec = Spec(root) if root else Spec()
    cell = spec.cell(cell_name)
    n, rank = int(cell.job["world"]), world.rank()
    if n != world.size():
        raise RuntimeError(f"{cell_name} runs {n} ranks; this process group "
                           f"has {world.size()} (start it by world.launch)")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    builder, reference = modules(cell.config["builder"])
    specs = reference.param_specs(cell.config)
    job = builder.build(cell.config, cell.job, weights.generate(specs, seed, dev),
                        dev)
    mark("built_s")
    try:
        batches = data.make(cell.config, cell.job, seed, dev, rank)
        plant(job, faults)
        prog = program_readings(job, batches, specs, cell, seed, dev)
        mark("first_steps_s")
        feed = itertools.cycle(batches[3:] + batches[:3])
        if trace:
            _open_ranges(job.opt)
        marks["warm_steps"] = _warm_up(job, feed, dev)
        clock = _Clock(dev)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        traced = None
        if trace:
            recorder = tracing.Recorder(cuda)
            recorder.start()
            with record_function(tracing.WINDOW):
                losses, events = _window(job.opt, feed, seconds, clock)
            traced = recorder.stop()
        else:
            losses, events = _window(job.opt, feed, seconds, clock)
        step_ms = clock.intervals_ms(events)
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        ranks = _gather({
            "steps": len(step_ms), "window_s": sum(step_ms) / 1e3,
            "setup_s": setup_s, "peak": max(peak, window_peak),
            "window_peak": window_peak,
            "failed": int((~torch.isfinite(torch.stack(losses))).sum()),
            "busy_s": traced.busy_s() if trace else None,
            "traced_s": traced.window_s if trace else None})
        info = RunInfo(
            cell=cell, steps=len(step_ms), step_ms=step_ms,
            window_s=max(r["window_s"] for r in ranks),
            setup_s=max(r["setup_s"] for r in ranks),
            items_per_step=data.items_per_step(cell.job) * n,
            peak_window_bytes=max(r["window_peak"] for r in ranks),
            trace=traced, busy_s=_mean(ranks, "busy_s"),
            traced_s=_mean(ranks, "traced_s"))
        metrics = {}
        for name in (cell.per_layer if trace else cell.end_to_end):
            value = spec.reader(name)(info)
            if value is not None:
                metrics[name] = {"value": value, "unit": spec.unit(name)}
    finally:
        job.close()
    del job, batches, feed, losses, events, traced
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference.readings(cell.config, cell.job, seed, dev, rank=rank,
                             world=n)
    checks = _worst(_gather(check.compare(prog, ref, cell.job["limits"])))
    failed = sum(r["failed"] for r in ranks)
    result = {
        "correct": failed == 0 and check.passed(checks),
        "attempted": sum(r["steps"] for r in ranks),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name() if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": max(r["peak"] for r in ranks),
        },
    }
    if trace:
        result["device"]["busy_s"] = info.busy_s
        result["device"]["window_s"] = info.traced_s
        result["breakdown"] = info.trace.breakdown()
    result["checks"] = checks
    timing = {**marks, "setup_s": info.setup_s, "window_s": info.window_s,
              "reference_s": time.perf_counter() - t_ref}
    return result, timing
