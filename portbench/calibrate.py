"""The readings that the output check's limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --base-seed <n> [--control 3] [--faults 3] [--out <file.jsonl>]

For each seed, in one process, at the cell's own sizes: the program's first
three steps (the set-up of a run, without its window) against the
reference's, and, on the first ``--control`` seeds, the control (the
reference computed from float8 operands) and, on the first ``--faults``
seeds, the program with half of each batch left out, each against the same
float32 reference. Prints one JSON line a reading and the summary: the
largest sound reading of each number, and the smallest of the control and
of the fault. The benchmark's runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def program_once(cell, seed: int, device, faults=()) -> dict:
    """The built step's readings of its first three steps; frees it after."""
    import torch

    from portbench import data, harness, weights

    builder, reference = harness.modules(cell.config["builder"])
    specs = reference.param_specs(cell.config)
    job = builder.build(cell.config, cell.job, weights.generate(specs, seed, device),
                        device)
    try:
        batches = data.make(cell.config, cell.job, seed, device)
        harness.plant(job, faults)
        return harness.program_readings(job, batches, specs, cell, seed, device)
    finally:
        job.close()
        del job
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def calibrate(cell, seeds, device, control: int, faults: int, emit=print):
    """Emit ``{"seed", "kind", <numbers>}`` for the program, the control
    and the fault on ``seeds``."""
    from portbench import check, harness

    _, reference = harness.modules(cell.config["builder"])
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        prog = program_once(cell, seed, device)
        ref = reference.readings(cell.config, cell.job, seed, device)
        emit({"seed": seed, "kind": "program", **check.gaps(prog, ref),
              "seconds": time.perf_counter() - t})
        if i < control:
            t = time.perf_counter()
            low = reference.readings(cell.config, cell.job, seed, device,
                                     precision="fp8")
            emit({"seed": seed, "kind": "control", **check.gaps(low, ref),
                  "seconds": time.perf_counter() - t})
        if i < faults:
            t = time.perf_counter()
            half = program_once(cell, seed, device, ("half_batch",))
            emit({"seed": seed, "kind": "half_batch", **check.gaps(half, ref),
                  "seconds": time.perf_counter() - t})


def summary(rows) -> dict:
    from portbench.check import NUMBERS

    out = {}
    for kind, pick in (("program", max), ("control", min), ("half_batch", min)):
        mine = [r for r in rows if r["kind"] == kind]
        if mine:
            out[kind] = {n: pick(r[n] for r in mine) for n in NUMBERS}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--base-seed", type=int, required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args()
    sys.path[0] = ROOT
    import torch

    from portbench.spec import Spec

    cell = Spec(ROOT).cell(args.workload)
    rows = []
    out = open(args.out, "a") if args.out else None

    def emit(row):
        rows.append(row)
        line = json.dumps({"workload": args.workload, **row})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    try:
        calibrate(cell, [args.base_seed + i for i in range(args.seeds)],
                  torch.device("cuda"), args.control, args.faults, emit)
    finally:
        if out:
            out.close()
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
