#!/usr/bin/env python3
"""Flash vs dense attention: the port's training losses side by side.

    python3 scripts/torch_port_loss_probe.py

Trains ``chip_smoke.py``'s main path (``chip_smoke.headline``: the
headline-width ``TransformerLM`` under ``DistributedNeighborAllreduceOptimizer``
around Adam, lr 1e-3, one repeated batch) at SEQ tokens for STEPS steps,
twice from the same seed — once with the CUDA flash kernels, once with the
dense ``reference_attention`` — and prints both loss curves. Needs one CUDA
card.
"""

from __future__ import annotations

import os
import sys
from functools import partial

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bluefog_tpu_torch as bf  # noqa: E402
import chip_smoke  # noqa: E402
from bluefog_tpu_torch.parallel import flash_attention  # noqa: E402
from bluefog_tpu_torch.parallel.context import reference_attention  # noqa: E402


SEQ = 2048
STEPS = 10


def losses(attn, dev) -> list:
    _, opt, batch = chip_smoke.headline(bf, torch, dev, attn, seq=SEQ)
    return [float(opt.step(batch)["loss"]) for _ in range(STEPS)]


def main() -> None:
    bf.init()
    dev = torch.device("cuda", torch.cuda.current_device())
    for name, attn in (("flash", flash_attention),
                       ("dense", partial(reference_attention, causal=True))):
        curve = losses(attn, dev)
        print(f"seq={SEQ} {name}: " + " ".join(f"{x:.4f}" for x in curve),
              flush=True)
        torch.cuda.empty_cache()
    bf.shutdown()


if __name__ == "__main__":
    main()
