"""A cell of more than one rank: one process a rank, each on its own card.

``launch`` starts the cell's ``world`` ranks as torchrun does, ``env://``
over a free port on localhost, each in ``python3 -m portbench.world``,
which runs ``harness.run`` for its rank. Each rank forms the process group
itself (``join``) before the port's ``bf.init`` joins it, so that what the
benchmark does across ranks uses a group that is not the program's:

  * the window's end: after each step the ranks agree on the host, over a
    gloo group, whether any rank's clock has passed the window, so all of
    them stop after the same step and none waits on a neighbour that left;
  * the readings: rank 0 gathers every rank's and prints the line, with the
    tokens or images of all ranks over the longest rank's window;
  * the reference's exchange with its neighbours (``reference/combine.py``).

Set-up counts from the launcher's start to the last rank's window.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_T0 = "PORTBENCH_T0"
_host_group = None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(cell: str, seed: int, seconds: float, trace: bool, world: int, *,
           started: Optional[float] = None, device: str = "cuda",
           root: Optional[str] = None, faults: Sequence[str] = (),
           timeout: float = 1200.0) -> Tuple[dict, dict]:
    """Run ``world`` ranks of ``cell``; rank 0's result and timing.
    ``started``: the run's start on the wall clock, where set-up counts
    from (now by default); ``faults``: as ``harness.plant`` takes them."""
    from portbench.spec import ROOT
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               PYTHONPATH=checkout, OMP_NUM_THREADS="1",
               **{_T0: repr(time.time() if started is None else started)})
    args = [sys.executable, "-m", "portbench.world", "--workload", cell,
            "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(int(trace)), "--device", device,
            "--root", root or ROOT, *(f"--fault={f}" for f in faults)]
    procs = [subprocess.Popen(args, cwd=checkout,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {cell} exited with {p.returncode}")
    line = json.loads(outs[0][0].strip().splitlines()[-1])
    return line["result"], line["timing"]


def join(device: str) -> torch.device:
    """Form the process group of this rank (NCCL on the card, gloo on the
    CPU) and a gloo group beside it for the host's agreements."""
    global _host_group
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", device_id=dev
                            if dev.type == "cuda" else None)
    _host_group = dist.new_group(backend="gloo")
    return dev


def leave() -> None:
    global _host_group
    if dist.is_initialized():
        dist.barrier(group=_host_group)
        dist.destroy_process_group()
    _host_group = None


def _host():
    if _host_group is None:
        raise RuntimeError("this rank has not joined its world (join)")
    return _host_group


def any_rank(flag: bool) -> bool:
    """True on every rank where ``flag`` is true on any (a host collective;
    the card is not waited on)."""
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host())
    return bool(t.item())


def gather(obj) -> List:
    """Every rank's ``obj``, in rank order, on every rank."""
    out = [None] * size()
    dist.all_gather_object(out, obj, group=_host())
    return out


def main() -> int:
    p = argparse.ArgumentParser(description="one rank of a cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", required=True)
    p.add_argument("--fault", action="append", default=[])
    args = p.parse_args()
    # the launcher's start on this process's clock
    t0 = time.perf_counter() - (time.time() - float(os.environ[_T0]))
    from portbench import harness
    from portbench.run import forbidden_modules

    dev = join(args.device)
    try:
        result, timing = harness.run(args.workload, args.seed, args.seconds,
                                     bool(args.trace), device=str(dev), t0=t0,
                                     root=args.root, faults=args.fault)
    finally:
        leave()
    found = forbidden_modules()
    if found:
        print(f"rank loaded {found}: the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    if int(os.environ["RANK"]) == 0:
        print(json.dumps({"result": result, "timing": timing}), flush=True)
    return 0


if __name__ == "__main__":
    # run as portbench.world, whose group the harness reads, not __main__
    from portbench import world
    sys.exit(world.main())
