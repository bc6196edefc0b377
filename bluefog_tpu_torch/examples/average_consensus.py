"""Average consensus via decentralized neighbor averaging.

The port of ``examples/average_consensus.py`` (itself the reference's
``examples/pytorch_average_consensus.py``): every rank starts with a random
vector and averages with its in-neighbors on the Exponential-2 graph,
60 rounds of ``neighbor_allreduce``, until all ranks agree on the global
mean.

Run at world 4 on the CPU (one process per rank):

    torchrun --standalone --nproc_per_node 4 \\
        -m bluefog_tpu_torch.examples.average_consensus --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util

ROUNDS = 60


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    bf.init(topology_util.ExponentialTwoGraph, device=args.device)
    try:
        return _run(torch.device(args.device))
    finally:
        bf.shutdown()


def _run(dev: torch.device) -> int:
    n, me = bf.size(), bf.rank()
    if me == 0:
        print(f"ranks: {n} on {dev.type}", flush=True)
    # every rank's start, from one seed: rank r holds row r
    start = np.random.RandomState(0).standard_normal((n, 1000))
    x = torch.from_numpy(start[me].astype(np.float32)).to(dev)
    target = torch.from_numpy(start.mean(0).astype(np.float32)).to(dev)

    for step in range(ROUNDS):
        x = bf.neighbor_allreduce(x, name=f"consensus.{step}")

    err = (x - target).abs().max()
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    ok = float(err) < 1e-4
    if me == 0:
        print(f"max deviation from rank-mean after {ROUNDS} rounds: "
              f"{float(err):.3e}")
        print("CONSENSUS OK" if ok else "CONSENSUS FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
