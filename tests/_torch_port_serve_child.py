"""A rank of the port's serving and launcher tests (world 4, gloo, CPU).

    python tests/_torch_port_serve_child.py MODE RANK WORLD TMP_DIR

Each rank joins its world through a FileStore under ``TMP_DIR`` and
attaches to the control plane the parent serves (``BFT_CP_HOST``/
``BFT_CP_PORT``, ``BFT_CP_SERVE=0``). The model is a seeded
``Linear(6, 3)`` under ``DistributedPushSumOptimizer`` around SGD 0.1,
each rank on its own rows of ``inputs.npz``; controller 0 publishes a
snapshot every step (``BFT_SERVE_PUBLISH_EVERY=1``).

* ``train_serve``: ``STEPS`` steps in lockstep with the parent: after each
  step rank 0 waits for ``test.serve.ack`` to reach the step (the parent's
  clients have served that version), then the world meets. Rank 0 saves
  its parameters after every step in ``out_0.npz``.
* ``attach_job``: 3 steps, then each rank publishes its metrics snapshot
  and its time series once and bumps ``test.ready``; the ranks stay alive
  (heartbeating, so a dump trigger is answered) until the parent sets
  ``test.done``.
"""

import os
import subprocess
import sys
import time

import numpy as np

STEPS = 3
WAIT_S = 120.0
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(mode: str, tmp_dir: str, world: int = 4) -> list:
    """Start ``world`` ranks of ``mode`` (the parent's environment, the
    repo on the path, each rank's output in ``log_<rank>.txt``); returns
    their processes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"log_{r}.txt"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode, str(r),
                 str(world), tmp_dir], env=env, cwd=tmp_dir, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def collect(procs: list, tmp_dir: str, timeout: float = 240.0) -> list:
    """Wait for every rank (killing the rest after ``timeout`` s); each
    rank's outputs, or RuntimeError with the log of a rank that failed."""
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp_dir, f"log_{r}.txt")) as f:
                raise RuntimeError(f"rank {r} ended with {p.returncode}:\n"
                                   f"{f.read()[-4000:]}")
    return [dict(np.load(os.path.join(tmp_dir, f"out_{r}.npz")))
            for r in range(len(procs))]


def _wait_key(cl, key: str, value: int) -> None:
    deadline = time.monotonic() + WAIT_S
    while cl.get(key) < value:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{key} never reached {value}")
        time.sleep(0.02)


def main() -> None:
    mode, rank, world, tmp_dir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.runtime import control_plane as cp
    from bluefog_tpu_torch.runtime import timeseries

    torch.set_num_threads(1)
    inp = dict(np.load(os.path.join(tmp_dir, "inputs.npz")))
    bf.init(device="cpu", init_method="file://" + os.path.join(
        tmp_dir, "store"), rank=rank, world_size=world)
    torch.manual_seed(0)
    model = torch.nn.Linear(6, 3)
    opt = bf.DistributedPushSumOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), model,
        lambda m, x: (m(x) ** 2).mean(), window_prefix="serve.child")
    x = torch.tensor(inp["x"][rank])
    cl = cp.client()
    out = {}
    if mode == "train_serve":
        for step in range(1, STEPS + 1):
            opt.step(x)
            if rank == 0:
                for i, p in enumerate(model.parameters()):
                    out[f"step{step}_p{i}"] = p.detach().numpy().copy()
                _wait_key(cl, "test.serve.ack", step)
            bf.barrier()
    elif mode == "attach_job":
        for _ in range(3):
            opt.step(x)
        bf.barrier()
        bf.metrics.publish_now()
        timeseries.maybe_sample(force=True, publish=True)
        bf.barrier()
        cl.fetch_add("test.ready", 1)
        _wait_key(cl, "test.done", 1)
    else:
        raise ValueError(f"unknown mode {mode}")
    bf.barrier()
    opt.free()
    bf.shutdown()
    np.savez(os.path.join(tmp_dir, f"out_{rank}.npz"), **out)


if __name__ == "__main__":
    main()
