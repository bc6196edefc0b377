"""Average consensus driven from a torch loop through the torch frontend.

The port of ``examples/torch_average_consensus.py`` (the reference's
``pytorch_average_consensus.py`` in its torch frontend): rank r takes row r
of one seeded ``[n, 1000]`` tensor and averages with its in-neighbours on
the default Exponential-2 graph, 60 rounds of the frontend's
``neighbor_allreduce``, until every rank holds the rank mean.

Run at world 4 on the CPU through the port's launcher (``--simulate`` puts
the ranks on the CPU even beside a GPU):

    python -m bluefog_tpu_torch.launcher --simulate 4 -- \\
        python -m bluefog_tpu_torch.examples.torch_average_consensus
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import torch_frontend as bft

ROUNDS = 60


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu; under bfrun --simulate "
                        "the default is the CPU")
    args = p.parse_args(argv)
    bf.init(device=args.device)
    try:
        return _run()
    finally:
        bf.shutdown()


def _run() -> int:
    n, me = bf.size(), bf.rank()
    dev = bf.runtime.state._global_state().device
    print(f"rank {me} of {n} on device {dev.type}", flush=True)
    start = torch.randn(n, 1000, generator=torch.Generator().manual_seed(0))
    x = start[me].to(dev)                  # row r is rank r's vector
    target = start.mean(dim=0).to(dev)
    for _ in range(ROUNDS):
        x = bft.neighbor_allreduce(x)
    dev_max = (x - target).abs().max()
    dist.all_reduce(dev_max, op=dist.ReduceOp.MAX)
    ok = float(dev_max) < 1e-4
    if me == 0:
        print(f"ranks: {n} (torch frontend)")
        print(f"max deviation from rank-mean after {ROUNDS} rounds: "
              f"{float(dev_max):.3e}")
        print("TORCH CONSENSUS OK" if ok else "TORCH CONSENSUS FAILED",
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
