"""Weights made from the seed, on the device, in one large draw.

A configuration's reference lists its parameters as ``(name, shape, init)``
with ``init`` one of ``("normal", std)``, ``("ones",)`` or ``("zeros",)``.
Every normal leaf is a view of one ``torch.randn`` over all of them, drawn
by a generator on the device, so the same seed gives the same weights to
the program's set-up and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], tuple]


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` for ``stream`` (1 weights, 2 inputs) of
    ``seed``, which may be any whole number of up to 64 bits."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 4 + stream) % (2 ** 63))
    return gen


def generate(specs: Sequence[Spec], seed: int,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 weights ``{name: tensor}`` of ``specs`` drawn from ``seed``."""
    sizes = [math.prod(shape) for _, shape, init in specs if init[0] == "normal"]
    flat = torch.randn(sum(sizes), generator=generator(seed, 1, device),
                       device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, init in specs:
        if init[0] == "normal":
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).mul_(init[1])
            off += n
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return out

