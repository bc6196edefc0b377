#!/usr/bin/env python3
"""What the optional part of the port's observability costs a train step.

    python3 scripts/torch_port_obs_overhead.py [--model lm|resnet50|all]
        [--rounds N]

Runs ``chip_smoke.py``'s overhead blocks (``_obs_blocks``) with more
rounds than the smoke does: ``N`` rounds (default 10) of off, on, on,
off blocks, where off is collection only (the metrics registry and the
flight ring: always on; no ``record_function`` range opens without a
profiler) and on adds the timeline and a 1 s Prometheus publisher. Each
block times the host's issue of ``chip_smoke.OBS_ISSUE_PROBES`` steps
one by one from an idle device, then a run of steps to a synchronise: 5
for ``lm`` (``chip_smoke.headline``, the headline flash LM under
``DistributedNeighborAllreduceOptimizer`` around Adam), 20 for
``resnet50`` (``bluefog_tpu_torch.bench.setup``'s step). Prints each
block, then per mode the median and the quartiles of ms/step and of host
issue ms, the on/off ratio of the medians, and how many of the rounds'
adjacent (off, on) pairs the on block lost. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bluefog_tpu_torch as bf  # noqa: E402
import chip_smoke  # noqa: E402
from bluefog_tpu_torch import bench  # noqa: E402
from bluefog_tpu_torch.parallel import flash_attention  # noqa: E402


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], statistics.median(xs), q[2]


def report(label: str, r: dict, rounds: int) -> None:
    order = ["off", "on", "on", "off"] * rounds
    seen = {"off": 0, "on": 0}
    for i, mode in enumerate(order):
        k = seen[mode]
        seen[mode] += 1
        print(f"{label} block {i:2d} {mode:3s}: ms/step {r[mode][k]:.4f} "
              f"host issue ms {r['issue_' + mode][k]:.4f}")
    for key in ("off", "on", "issue_off", "issue_on"):
        lo, med, hi = _quartiles(r[key])
        print(f"{label} {key}: median {med:.4f} quartiles {lo:.4f} "
              f"{hi:.4f}")
    # each round's blocks pair as (off, on) and (on, off)
    lost = sum(r["on"][j] > r["off"][j] for j in range(2 * rounds))
    ratio = statistics.median(r["on"]) / statistics.median(r["off"])
    print(f"{label}: on/off of the medians {ratio:.4f}, of the sums "
          f"{r['ratio']:.4f}; on slower in {lost} of {2 * rounds} adjacent "
          f"pairs; on-blocks with a publication {r['published']} of "
          f"{2 * rounds}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--model", choices=("lm", "resnet50", "all"),
                    default="all")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_obs_overhead: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="bft_obs_") as tmp:
        if args.model in ("lm", "all"):
            bf.init()
            dev = torch.device("cuda", torch.cuda.current_device())
            _, opt, batch = chip_smoke.headline(bf, torch, dev,
                                                flash_attention)
            for _ in range(chip_smoke.WARMUP):
                opt.step(batch)
            r = chip_smoke._obs_blocks(
                bf, lambda: opt.step(batch), torch.cuda.synchronize,
                chip_smoke.OBS_LM_STEPS, tmp, "lm", args.rounds)
            bf.shutdown()
            del opt, batch
            torch.cuda.empty_cache()
            report("LM", r, args.rounds)
        if args.model in ("resnet50", "all"):
            opt, batch, sync = bench.setup()
            for _ in range(bench.WARMUP):
                opt.step(batch)
            r = chip_smoke._obs_blocks(
                bf, lambda: opt.step(batch), sync,
                chip_smoke.OBS_VISION_STEPS, tmp, "resnet50", args.rounds)
            bf.shutdown()
            report("ResNet-50", r, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
