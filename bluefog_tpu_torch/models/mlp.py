"""Small models: ``MLP`` and ``LeNet5``.

Counterparts of ``bluefog_tpu/models/mlp.py`` (``MLP`` :17, ``LeNet5`` :33),
with flax's auto names (``Dense_<i>``, ``Conv_<i>``). The JAX models infer
their input width at init; the port takes it as an argument
(``in_features``, ``image_size``). Both flatten in NHWC order, as JAX does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime.state import resolve_device
from .layers import Conv, Dense, init_weights, nhwc_flatten


class MLP(nn.Module):
    """Plain MLP over the flattened input (784 = a flattened MNIST image)."""

    def __init__(self, in_features: int = 784,
                 features: Sequence[int] = (128, 128, 10),
                 dtype: torch.dtype = torch.float32, *, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.num_layers = len(features)
        d_in = in_features
        for i, f in enumerate(features):
            setattr(self, f"Dense_{i}", Dense(d_in, f, dtype, dev))
            d_in = f
        init_weights(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x.float()


class LeNet5(nn.Module):
    """The conv net of the reference MNIST example: two 5x5 convs ("SAME")
    with 2x2 max-pools, then Dense(512) and the classifier. Input
    [B, H, W] or [B, H, W, 1]."""

    def __init__(self, num_classes: int = 10, image_size: int = 28,
                 dtype: torch.dtype = torch.float32, *, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.Conv_0 = Conv(1, 32, 5, bias=True, dtype=dtype, device=dev)
        self.Conv_1 = Conv(32, 64, 5, bias=True, dtype=dtype, device=dev)
        side = image_size // 2 // 2
        self.Dense_0 = Dense(side * side * 64, 512, dtype, dev)
        self.Dense_1 = Dense(512, num_classes, dtype, dev)
        init_weights(self, seed)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = F.relu(self.Dense_0(nhwc_flatten(x)))
        return self.Dense_1(x).float()
