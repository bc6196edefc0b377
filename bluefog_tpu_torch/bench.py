"""Benchmark: ResNet-50 decentralized training throughput, one process per card.

    python -m bluefog_tpu_torch.bench [--host-data] [--prefetch N]
                                      [--steps-scale X]

Counterpart of the root ``bench.py`` with its constants: synthetic ImageNet
batches of 128 per card at 224x224, 10 warm-up steps, then 10 iterations of
10 steps in one timed window closed by one ``torch.cuda.synchronize()``.
Each step is the flagship fused step (``DistributedNeighborAllreduceOptimizer``
around SGD lr 0.1, momentum 0.9): backward, update, Expo-2 neighbor
averaging of the parameters (``FullyConnectedGraph(1)`` at world 1). The
model is ``ResNet50`` (1000 classes, bf16 compute, f32 parameters and BN
statistics, ``channels_last``). The world is the process group a launcher
set up (``torchrun``'s environment), else one process.

``--host-data`` feeds uint8 batches from a host pool through
``prefetch_to_device`` (pinned memory, ``--prefetch`` transfers in flight)
instead of one batch resident on the card.

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline",
"baseline", "device"}``. ``vs_baseline`` is against the reference BlueFog's
published V100 figure, ``Total img/sec on 16 GPU(s): 4310.6`` => 269.4
img/s per V100 (docs/performance.rst:20-24): a yardstick on other hardware,
not a target.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time

import numpy as np
import torch

from . import topology as topology_util
from .models import ResNet50, classification_loss
from .optimizers import DistributedNeighborAllreduceOptimizer
from .runtime.state import _global_state, init, shutdown
from .utils.data import prefetch_to_device

BATCH_PER_CHIP = 128
IMAGE = 224
WARMUP = 10
ITERS = 10
BATCHES_PER_ITER = 10
BASELINE_IMG_SEC_PER_DEVICE = 4310.6 / 16  # reference 16xV100 result
BASELINE = ("reference BlueFog, 4310.6 img/s on 16 V100 = 269.4 img/s per "
            "V100 (docs/performance.rst:20-24)")


def _topology(n: int):
    return topology_util.ExponentialTwoGraph(n) if n > 1 else \
        topology_util.FullyConnectedGraph(1)


def setup(batch_per_chip: int = BATCH_PER_CHIP, synthetic_batch: bool = True,
          device=None):
    """Build the benchmark step: ``(opt, batch, sync)``.

    Joins (or forms) the process group with ``bf.init``; the caller owns
    ``bf.shutdown()``. ``opt.step(batch)`` is one training step and
    ``opt.model`` the ResNet-50 (seed 0). ``batch`` is this rank's
    synthetic batch on the card (normal images, all labels 0, as the root
    ``bench.py``), or None with ``synthetic_batch=False`` (host-data mode
    feeds its own). ``sync()`` waits for the device. On CUDA this turns on
    ``torch.backends.cudnn.benchmark`` (cuDNN times its algorithms per
    shape on first use: the counterpart of XLA's conv autotuning).
    """
    init(topology_fn=_topology, device=device)
    dev = _global_state().device
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device=dev,
                     seed=0)
    opt = DistributedNeighborAllreduceOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), model,
        classification_loss)
    batch = None
    if synthetic_batch:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_global_state().rank)
        images = torch.randn((batch_per_chip, IMAGE, IMAGE, 3),
                             generator=gen, device=dev)
        labels = torch.zeros(batch_per_chip, dtype=torch.int64, device=dev)
        batch = (images, labels)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    return opt, batch, sync


def host_batch_pool(batch_per_chip: int, pool: int = 4, image: int = IMAGE,
                    rank: int = 0):
    """Endless cycle over ``pool`` distinct host uint8 batches of this rank
    (int64 labels): the stand-in for a real data loader."""
    rng = np.random.default_rng([7, rank])
    batches = [
        (torch.from_numpy(rng.integers(0, 256, (batch_per_chip, image, image,
                                                3), dtype=np.uint8)),
         torch.from_numpy(rng.integers(0, 1000, (batch_per_chip,),
                                       dtype=np.int64)))
        for _ in range(pool)
    ]
    return itertools.cycle(batches)


def run(opt, feed, sync, warmup: int, steps: int) -> dict:
    """``warmup`` untimed steps, then ``steps`` timed ones in one window
    closed by ``sync()``. Returns the window's seconds and every loss."""
    losses = [opt.step(next(feed))["loss"] for _ in range(warmup)]
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(opt.step(next(feed))["loss"])
    sync()
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "losses": [float(x) for x in losses]}


def main(host_data: bool = False, prefetch: int = 2,
         steps_scale: float = 1.0) -> None:
    opt, batch, sync = setup(synthetic_batch=not host_data)
    try:
        st = _global_state()
        iters = max(1, round(ITERS * steps_scale))
        if host_data:
            feed = prefetch_to_device(
                host_batch_pool(BATCH_PER_CHIP, rank=st.rank), size=prefetch,
                device=st.device)
            metric = "resnet50_train_img_per_sec_per_chip_hostfeed"
        else:
            feed = itertools.repeat(batch)
            metric = "resnet50_train_img_per_sec_per_chip"
        res = run(opt, feed, sync, WARMUP, iters * BATCHES_PER_ITER)
        per_device = BATCH_PER_CHIP * BATCHES_PER_ITER * iters / \
            res["seconds"]
        out = {
            "metric": metric,
            "value": round(per_device, 2),
            "unit": "img/s/chip",
            "vs_baseline": round(per_device / BASELINE_IMG_SEC_PER_DEVICE, 3),
            "baseline": BASELINE,
            "device": torch.cuda.get_device_name(st.device),
        }
        if st.rank == 0:
            print(json.dumps(out))
    finally:
        shutdown()


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host-data", action="store_true",
                   help="feed uint8 batches from host memory through the "
                        "pinned, prefetched pipeline (real host->device "
                        "traffic)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="host->device transfers kept in flight")
    p.add_argument("--steps-scale", type=float, default=1.0,
                   help="scale the timed iteration count")
    a = p.parse_args()
    main(host_data=a.host_data, prefetch=a.prefetch,
         steps_scale=a.steps_scale)
