"""Train-while-serve: a gossip trainer publishing versioned snapshots while
a read-only client answers batched inference from them.

The port of ``examples/serving.py``. The trainer side is one knob:
``BFT_SERVE_PUBLISH_EVERY=N`` makes controller 0 write its post-gossip
parameters to the control plane as an immutable, shard-striped snapshot
every N-th communicating step, behind a monotone version fence, so a reader
sees a complete snapshot or the previous one, never a torn mix.

The serving side is a raw control-plane attachment (the kind ``python -m
bluefog_tpu_torch.launcher --status`` uses): it joins no process group and
runs on any host that reaches the control-plane address. Here both sides
share one process (rank 0's, under ``torchrun``); point
``bf.serve_client`` (or ``python -m bluefog_tpu_torch.launcher --serve``)
at a job's address to run them on different machines.

    python -m bluefog_tpu_torch.examples.serving [--device cpu]
    torchrun --standalone --nproc_per_node 4 \\
        -m bluefog_tpu_torch.examples.serving --device cpu

At world 1 the example serves a loopback control plane of its own; the
knobs it sets for that are restored when it returns.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import socket
import sys

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch.runtime.control_plane import PORT_OFFSET
from bluefog_tpu_torch.runtime.state import resolve_device

DIM = 512
STEPS = 20


@contextlib.contextmanager
def _serving_env():
    """The example's knobs, each only where the caller left it unset: a
    publish every communicating step, a 0.2 s poll, and (outside a
    ``torchrun`` world) a loopback control plane on a free port. Restored
    on exit."""
    want = {"BFT_SERVE_PUBLISH_EVERY": "1", "BFT_SERVE_POLL_S": "0.2"}
    if not os.environ.get("BFT_CP_HOST") and \
            int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        want.update({"BFT_CP_HOST": "127.0.0.1",
                     "BFT_CP_PORT": str(s.getsockname()[1]),
                     "BFT_CP_WORLD": "1", "BFT_CP_RANK": "0"})
        s.close()
    saved = {k: os.environ.get(k) for k in want}
    for k, v in want.items():
        if not saved[k]:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _endpoints():
    """The control plane the job attached to: ``BFT_CP_HOST``/``PORT``,
    else ``torchrun``'s ``MASTER_ADDR`` and ``MASTER_PORT + 17``."""
    if os.environ.get("BFT_CP_HOST"):
        return [(os.environ["BFT_CP_HOST"], int(os.environ["BFT_CP_PORT"]))]
    return [(os.environ["MASTER_ADDR"],
             int(os.environ["MASTER_PORT"]) + PORT_OFFSET)]


class Ridge(torch.nn.Module):
    """One weight vector: a least-squares fit to a fixed linear target."""

    def __init__(self, dim: int, dev: torch.device) -> None:
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(dim, device=dev))


def ridge_loss(model: Ridge, batch) -> torch.Tensor:
    x, y = batch
    pred = x @ model.w
    return ((pred - y) ** 2).mean() + 1e-4 * (model.w ** 2).sum()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--steps", type=int, default=STEPS)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    with _serving_env():
        bf.init(device=dev.type)
        try:
            return _run(dev, args.steps)
        finally:
            bf.shutdown()


def _run(dev: torch.device, steps: int) -> int:
    me = bf.rank()
    if me == 0:
        print(f"ranks: {bf.size()}", flush=True)
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(DIM,)).astype(np.float32)
    xs_train = rng.normal(size=(256, DIM)).astype(np.float32)
    ys_train = xs_train @ w_true

    model = Ridge(DIM, dev)
    opt = bf.DistributedPushSumOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-2), model, ridge_loss,
        window_prefix="example.serve")

    # the serving client (rank 0's process): model_fn(params, batch) over
    # the snapshot's leaves, tensors on the client's device in parameter
    # order, so params[0] is controller 0's w
    def model_fn(params, xs):
        return xs @ params[0]

    sc = bf.serve_client(model_fn, endpoints=_endpoints(),
                         device=dev) if me == 0 else None
    batch = (torch.from_numpy(xs_train).to(dev),
             torch.from_numpy(ys_train).to(dev))
    ok = True
    try:
        # train; the publisher hook ships a snapshot every communicating
        # step and the client hot-swaps behind our back
        for step in range(1, steps + 1):
            opt.step(batch)
            if sc is None:
                continue
            if step == 1 and not sc.wait_ready(timeout=30):
                print("serving: no snapshot within 30 s", file=sys.stderr)
                ok = False
                break
            if step % 5 == 0:
                q = rng.normal(size=(4, DIM)).astype(np.float32)
                preds = np.stack([sc.infer(q[i], timeout=10)
                                  for i in range(4)])
                err = float(np.max(np.abs(preds - q @ w_true)))
                st = sc.stats()
                print(f"step {step:2d}: serving v{st['version']} "
                      f"({st['swaps']} swaps, {st['batches']} batches) "
                      f"max |pred - true| = {err:.3f}", flush=True)
        if sc is not None:
            ok = ok and sc.version() >= 1
    finally:
        if sc is not None:
            sc.close()
        bf.barrier()
        opt.free()
    if me == 0:
        print("SERVING OK" if ok else
              "SERVING FAILED (no snapshot version)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
