"""VGG-11/16/19, the reference benchmark's second model family.

Counterpart of ``bluefog_tpu/models/vgg.py`` (``VGG`` :37, ``VGG11/16/19``
:91-93): torchvision's configurations A/D/E, the batch-norm variant by
default with the conv biases kept, two 4096-wide dense layers and the
classifier. Names follow the flax tree (``conv_<i>``, ``bn_<i>`` at the
config index ``i``, ``fc_0``, ``fc_1``, ``head``).

The JAX model's static analog of torchvision's adaptive 7x7 average pool
(:80-82) is kept: a post-conv map that is a multiple of 7 (224 -> 7, 448 ->
14) is average-pooled to 7x7; other sizes flatten as they are. The map is
flattened in NHWC order, as JAX does, so ``fc_0`` maps one to one. The
port takes ``image_size`` to size ``fc_0`` (JAX infers it at init).

Dropout draws its masks from the model's own ``torch.Generator`` (seeded
from ``seed``); they cannot match JAX's bit for bit.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime.state import resolve_device
from .layers import BatchNorm, Conv, Dense, init_weights, nhwc_flatten

# torchvision cfgs: ints are conv widths, "M" is a 2x2 max-pool.
_CFGS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    """Configurable VGG over NHWC inputs of 3 channels."""

    def __init__(self, cfg: Sequence[Union[int, str]],
                 num_classes: int = 1000, batch_norm: bool = True,
                 dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 224,
                 *, device=None, seed: int = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = tuple(cfg)
        self.batch_norm = batch_norm
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        cin, side = 3, image_size
        for i, v in enumerate(self.cfg):
            if v == "M":
                side //= 2
                continue
            setattr(self, f"conv_{i}",
                    Conv(cin, v, 3, bias=True, dtype=dtype, device=dev))
            if batch_norm:
                setattr(self, f"bn_{i}", BatchNorm(v, dtype, device=dev))
            cin = v
        self.pool = side // 7 if side != 7 and side % 7 == 0 else 1
        side //= self.pool
        self.fc_0 = Dense(side * side * cin, 4096, dtype, dev)
        self.fc_1 = Dense(4096, 4096, dtype, dev)
        self.head = Dense(4096, num_classes, dtype, dev)
        init_weights(self, seed)
        self.dropout_generator = torch.Generator(device=dev)
        self.dropout_generator.manual_seed(seed + 1)
        self.to(memory_format=torch.channels_last)

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.dropout_rate == 0.0:
            return x
        keep = 1.0 - self.dropout_rate
        mask = torch.rand(x.shape, generator=self.dropout_generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: [B, H, W, 3] -> f32 logits [B, num_classes]."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for i, v in enumerate(self.cfg):
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f"conv_{i}")(x)
            if self.batch_norm:
                x = getattr(self, f"bn_{i}")(x)
            x = F.relu(x)
        if self.pool > 1:
            x = F.avg_pool2d(x, self.pool, self.pool)
        x = nhwc_flatten(x)
        x = self._dropout(F.relu(self.fc_0(x)))
        x = self._dropout(F.relu(self.fc_1(x)))
        return self.head(x).float()


VGG11 = partial(VGG, cfg=_CFGS[11])
VGG16 = partial(VGG, cfg=_CFGS[16])
VGG19 = partial(VGG, cfg=_CFGS[19])
