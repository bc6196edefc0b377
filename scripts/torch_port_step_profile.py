#!/usr/bin/env python3
"""Where a train step of the port spends its device time.

    python3 scripts/torch_port_step_profile.py
        [--model lm|moe|resnet50|zero1] [--chunked-ce]

``lm`` (default) builds ``chip_smoke.py``'s main path
(``chip_smoke.headline``: the headline-width flash ``TransformerLM`` under
``DistributedNeighborAllreduceOptimizer`` around Adam, ``LAYERS`` layers,
``SEQ`` tokens; ``--chunked-ce`` trains it with ``chunked_ce_loss`` in
place of the full-logits loss), runs ``WARMUP`` steps, then traces
``STEPS`` steps. ``moe`` does the same for ``chip_smoke.py``'s MoE LM at
the headline width (``MOE_EXPERTS`` experts, blocks 1 and 3 MoE, always
``chunked_ce_loss``). ``zero1`` trains the headline LM under
``DistributedShardedAllreduceOptimizer`` (ZeRO-1) around the same Adam.
``resnet50`` builds the benchmark's step (``bluefog_tpu_torch.bench.setup``:
ResNet-50, batch 128 at 224x224, SGD 0.1/0.9, cuDNN autotuning on), runs
``bench.WARMUP`` steps, then traces 10 steps. Both first time the steps
without the profiler (host clock, ending in ``torch.cuda.synchronize``) and
the host's own time per step (call to return of one step issued after a
synchronize: the launches alone, while the device's queue is far from
full). Then they trace as many steps with ``torch.profiler``, recording
device activity only (recording host operations too doubles the host's
time per step; device tracing alone still adds host time per launch, which
starves a device whose queue the host barely keeps ahead of, as in the
ResNet-50 step), and print from that one window:
its wall time, the device busy time (the union of kernel, copy and set
intervals), the busy share (busy time over the window's wall time) and the
device idle share between the first and last device event; then the
device time grouped by kernel family, device events per step, the time of
the optimizer's parameter combine alone (pack, weights, unpack, copy back;
CUDA events) or, for ``zero1``, of each pass of its step alone (and of Adam
over the model's tensors one by one, for comparison), and the summed
device time of the top 25 kernels. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bluefog_tpu_torch as bf  # noqa: E402
import chip_smoke  # noqa: E402
from bluefog_tpu_torch import bench  # noqa: E402
from bluefog_tpu_torch.parallel import flash_attention  # noqa: E402

# first match wins: pooling before the convolutions (its NHWC kernels),
# the convolutions before the matmuls, whose cuDNN and cuBLAS kernel names
# share prefixes (sm90_xmma, cutlass); cuDNN runs some 1x1 convolutions as
# plain GEMM kernels, which land with the matmuls
_GROUPS = (("flash kernels", ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                              "flash_bwd_dkv_kernel")),
           ("batch norm", ("batch_norm",)),
           ("optimizer (foreach)", ("multi_tensor",)),
           ("pooling", ("max_pool", "avg_pool")),
           ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "conv",
                                     "implicit", "nhwc", "Nhwc")),
           ("matmuls (cuBLAS, cuDNN GEMM)", ("gemm", "Gemm", "sm90_xmma",
                                             "cutlass", "nvjet")))


def _group(name: str) -> str:
    for label, keys in _GROUPS:
        if any(k in name for k in keys):
            return label
    return "other elementwise"


def _lm(chunked_ce: bool = False, **moe):
    bf.init()
    dev = torch.device("cuda", torch.cuda.current_device())
    loss = chip_smoke.chunked_lm_loss if chunked_ce else None
    _, opt, batch = chip_smoke.headline(bf, torch, dev, flash_attention,
                                        loss_fn=loss, **moe)
    return opt, itertools.repeat(batch), chip_smoke.WARMUP, chip_smoke.STEPS


def _zero1():
    bf.init()
    dev = torch.device("cuda", torch.cuda.current_device())
    model = chip_smoke.headline_model(bf, torch, dev, flash_attention)
    opt = bf.DistributedShardedAllreduceOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), model,
        bf.models.lm_loss)
    return (opt, itertools.repeat(chip_smoke.headline_batch(torch, dev)),
            chip_smoke.WARMUP, chip_smoke.STEPS)


def _zero1_passes(opt) -> None:
    """Each pass of the ZeRO-1 step alone (CUDA events, 10 launches), and
    Adam over the model's parameter tensors (views of the same buffer)."""
    import torch.distributed as dist

    from bluefog_tpu_torch.ops.collectives import (_all_gather_flat,
                                                   _reduce_scatter_flat)

    flat_g = opt._flat_g
    (shard,) = opt.base.param_groups[0]["params"]
    other = torch.ones_like(flat_g)
    per_tensor = torch.optim.Adam(opt.model.parameters(), lr=1e-3)
    passes = {
        "zero the gradient buffer": flat_g.zero_,
        "one add over the gradient buffer (the backward's accumulation)":
            lambda: flat_g.add_(other),
        "reduce-scatter in place": lambda: _reduce_scatter_flat(
            shard.grad, flat_g, op=dist.ReduceOp.SUM),
        "divide the shard's gradient by n": lambda: shard.grad.div_(
            bf.size()),
        "Adam on the flat shard": opt.base.step,
        "all-gather in place": lambda: _all_gather_flat(opt._flat_p,
                                                        shard.detach()),
        "Adam over the model's tensors (not in the step)": per_tensor.step,
    }
    print(f"zero1 flat buffer: {flat_g.numel()} elements of {flat_g.dtype}")
    for name, fn in passes.items():
        print(f"zero1 pass alone: {name}: "
              f"{chip_smoke.cuda_ms(fn, 10):.3f} ms")


def _resnet50():
    opt, batch, _ = bench.setup()
    flop = _conv_flop(opt.model, batch[0])
    print(f"convolution and head FLOP per step (forward, and input and "
          f"weight gradients; from the shapes): {flop:.4e}; at "
          f"{chip_smoke.PEAK_BF16:.3e} FLOP/s bf16: "
          f"{flop / chip_smoke.PEAK_BF16 * 1e3:.3f} ms")
    return opt, itertools.repeat(batch), bench.WARMUP, 10


def _conv_flop(model, images) -> float:
    """2*MACs of every Conv and Dense in one forward, times 3 (the input
    gradient and the weight gradient cost as much each), less the stem's
    input gradient, which nothing needs."""
    from bluefog_tpu_torch.models.layers import Conv, Dense

    macs = []

    def hook(mod, inp, out):
        k = mod.weight[0].numel()          # cin * kh * kw, or d_in
        macs.append(out.numel() * k)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv, Dense))]
    with torch.no_grad():
        model.eval()(images)               # eval: the BN buffers stay put
    model.train()
    for h in handles:
        h.remove()
    return 3 * 2 * sum(macs) - 2 * macs[0]


def _device_events(prof) -> list:
    """(name, start us, duration us) of every kernel, copy and set in the
    trace; the user annotations mirrored onto the device timeline span
    kernels already counted and are left out."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return [(e["name"], float(e["ts"]), float(e["dur"]))
            for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in
            ("kernel", "gpu_memcpy", "gpu_memset")]


def _union_us(events) -> float:
    busy, end = 0.0, float("-inf")
    for _, ts, dur in sorted(events, key=lambda e: e[1]):
        lo = max(ts, end)
        if ts + dur > lo:
            busy += ts + dur - lo
        end = max(end, ts + dur)
    return busy


def main(model: str, chunked_ce: bool = False) -> None:
    if model == "resnet50":
        opt, feed, warmup, steps = _resnet50()
    elif model == "zero1":
        opt, feed, warmup, steps = _zero1()
    elif model == "moe":
        opt, feed, warmup, steps = _lm(
            True, num_experts=chip_smoke.MOE_EXPERTS, moe_every=2)
    else:
        opt, feed, warmup, steps = _lm(chunked_ce)
    for _ in range(warmup):
        opt.step(next(feed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        opt.step(next(feed))
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    host = []
    for _ in range(steps):
        t0 = time.perf_counter()
        opt.step(next(feed))
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            opt.step(next(feed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = _device_events(prof)
    kernels = {}
    for name, _, dur in events:
        kernels[name] = kernels.get(name, 0.0) + dur
    total_us = sum(kernels.values())
    busy_us = _union_us(events)
    span_us = max(ts + dur for _, ts, dur in events) - \
        min(ts for _, ts, _ in events)
    print(f"model {model} (chunked ce: {chunked_ce or model == 'moe'}); "
          f"card: {torch.cuda.get_device_name(0)}")
    print(f"wall ms/step {plain_wall / steps * 1e3:.3f} without the profiler, "
          f"{wall / steps * 1e3:.3f} traced; host ms/step issuing one step "
          f"{sum(host) / steps * 1e3:.3f} (min {min(host) * 1e3:.3f}); "
          f"device busy ms/step {busy_us / steps / 1e3:.3f}; busy share of "
          f"the traced window {busy_us / 1e6 / wall:.4f}; device idle share "
          f"between its first and last event {1 - busy_us / span_us:.4f}; "
          f"device events per step {len(events) / steps:.1f}")
    if model == "zero1":
        with torch.no_grad():
            _zero1_passes(opt)
    else:
        ps = [p.detach() for p in opt._params]
        plan = opt._plan()

        def combine():
            with torch.no_grad():
                for p, v in zip(ps, opt._combine(ps, plan)):
                    p.copy_(v)

        print(f"combine alone ({sum(p.numel() for p in ps)} parameters): "
              f"{chip_smoke.cuda_ms(combine, 10):.3f} ms")
    groups = {}
    for name, us in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + us
    for label, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"group {label}: {us / steps / 1e3:.3f} ms/step "
              f"({us / total_us:.4f} of device time)")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:25]:
        print(f"kernel {us / steps / 1e3:9.3f} ms/step  [{_group(name)}]  "
              f"{name[:110]}")
    bf.shutdown()


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", choices=("lm", "moe", "resnet50", "zero1"),
                   default="lm")
    p.add_argument("--chunked-ce", action="store_true",
                   help="train the LM with chunked_ce_loss")
    a = p.parse_args()
    main(a.model, a.chunked_ce)
