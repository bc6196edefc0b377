"""The general input generator: a cell's pool of batches from the seed.

It reads the ``inputs`` of ``cells/<cell>.json``:

  * ``{"kind": "tokens", "batch": B, "seq_len": S}``: token ids uniform over
    the configuration's ``vocab_size``, targets the same row shifted by one;
  * ``{"kind": "images", "batch": B, "size": P}``: NHWC float32 images drawn
    normal, labels uniform over the configuration's ``num_classes``.

``pool`` batches are drawn in one call each, on the device, from the seed.
Every batch has the same sizes, so every seed gives the same work.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .weights import generator

Batch = Tuple[torch.Tensor, torch.Tensor]


def make(config: dict, job: dict, seed: int, device: torch.device,
         rank: int = 0) -> List[Batch]:
    """The pool of ``rank``; rank r draws what rank 0 would from seed + r."""
    spec = job["inputs"]
    pool = int(job["pool"])
    gen = generator(seed + rank, 2, device)
    B = int(spec["batch"])
    if spec["kind"] == "tokens":
        S = int(spec["seq_len"])
        rows = torch.randint(0, int(config["vocab_size"]), (pool, B, S + 1),
                             generator=gen, device=device)
        return [(rows[i, :, :-1].contiguous(), rows[i, :, 1:].contiguous())
                for i in range(pool)]
    if spec["kind"] == "images":
        P = int(spec["size"])
        images = torch.randn((pool, B, P, P, 3), generator=gen, device=device)
        labels = torch.randint(0, int(config["num_classes"]), (pool, B),
                               generator=gen, device=device)
        return [(images[i], labels[i]) for i in range(pool)]
    raise ValueError(f"unknown inputs kind {spec['kind']!r}")


def items_per_step(job: dict) -> int:
    """Tokens or images one rank's step consumes."""
    spec = job["inputs"]
    if spec["kind"] == "tokens":
        return int(spec["batch"]) * int(spec["seq_len"])
    return int(spec["batch"])
