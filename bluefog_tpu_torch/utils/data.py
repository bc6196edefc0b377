"""Host input pipeline: prefetched, double-buffered device feeding.

Counterpart of ``bluefog_tpu/utils/data.py``. A host batch is copied into
pinned memory and sent with ``.to(device, non_blocking=True)``, which
returns at once; keeping ``size`` such transfers queued ahead of the
consumer overlaps the copy of batch ``t+1`` with step ``t``'s compute.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

from ..runtime.state import resolve_device


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device=None) -> Iterator:
    """Yield device-resident batches, keeping ``size`` transfers in flight.

    ``iterator`` yields host batches: tensors or numpy arrays, alone or in
    tuples, lists and dicts. ``device`` defaults to ``cuda`` (raising
    without a card) and may be ``"cpu"``. Tensors already on ``device``
    pass through untouched.
    """
    # validate HERE (not inside the generator) so a bad size raises at the
    # call site instead of at the consumer's first next()
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            if x.device == dev:
                return x
            if dev.type == "cuda" and x.device.type == "cpu":
                x = x.pin_memory()
            return x.to(dev, non_blocking=True)
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        return x

    def gen():
        queue: collections.deque = collections.deque()
        for batch in iterator:
            queue.append(put(batch))
            if len(queue) >= size:
                yield queue.popleft()
        while queue:
            yield queue.popleft()

    return gen()
