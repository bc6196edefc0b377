#!/usr/bin/env python3
"""Where the port's headline train step spends its device time.

    python3 scripts/torch_port_step_profile.py

Builds ``chip_smoke.py``'s main path (``chip_smoke.headline``: the
headline-width flash ``TransformerLM`` under
``DistributedNeighborAllreduceOptimizer`` around Adam, ``LAYERS`` layers,
``SEQ`` tokens), runs ``WARMUP`` steps, then traces ``STEPS`` steps with
``torch.profiler`` and prints: the step's wall time, the summed device time
per kernel (top 15), the device time grouped into flash kernels / matmuls /
the rest, and the device busy share of the traced window. Needs one CUDA
card.
"""

from __future__ import annotations

import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bluefog_tpu_torch as bf  # noqa: E402
import chip_smoke  # noqa: E402
from bluefog_tpu_torch.parallel import flash_attention  # noqa: E402

_GROUPS = (("flash kernels", ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                              "flash_bwd_dkv_kernel")),
           ("matmuls (cuBLAS)", ("gemm", "Gemm", "sm90_xmma", "cutlass",
                                 "nvjet")),
           ("optimizer (Adam, foreach)", ("multi_tensor",)))


def _group(name: str) -> str:
    for label, keys in _GROUPS:
        if any(k in name for k in keys):
            return label
    return "other"


def main() -> None:
    bf.init()
    dev = torch.device("cuda", torch.cuda.current_device())
    _, opt, batch = chip_smoke.headline(bf, torch, dev, flash_attention)
    for _ in range(chip_smoke.WARMUP):
        opt.step(batch)
    torch.cuda.synchronize()
    steps = chip_smoke.STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            opt.step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events, minus the user annotations that torch mirrors
    # onto the GPU timeline under their CPU range's name
    # (``Optimizer.step#Adam.step``): those span kernels already counted
    cpu_names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and \
                evt.name not in cpu_names:
            kernels[evt.name] = kernels.get(evt.name, 0.0) + \
                evt.time_range.elapsed_us()
    busy_us = sum(kernels.values())
    step_ms = wall / steps * 1e3
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"wall ms/step {step_ms:.3f}; device busy ms/step "
          f"{busy_us / steps / 1e3:.3f}; busy share "
          f"{busy_us / 1e3 / (wall * 1e3):.4f}")
    groups = {}
    for name, us in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + us
    for label, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"group {label}: {us / steps / 1e3:.3f} ms/step "
              f"({us / busy_us:.4f} of device time)")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"kernel {us / steps / 1e3:9.3f} ms/step  {name[:110]}")
    bf.shutdown()


if __name__ == "__main__":
    main()
