"""ResNet v1.5 — the benchmark model (``bench.py``).

Counterpart of ``bluefog_tpu/models/resnet.py`` (``BottleneckBlock`` :28,
``BasicBlock`` :58, ``ResNet`` :83, ``ResNet18/34/50/101`` :164-167).
Submodule names follow the flax tree (``conv_init`` or ``conv_init_s2d``,
``bn_init``, ``<Block>_<i>`` holding ``Conv_0..2``/``BatchNorm_0..2``,
``conv_proj``/``norm_proj``, ``head``), so ``utils.interop.params_from_jax``
maps one to the other and ``fold_batchnorm`` pairs norms with convs by the
same rule as the JAX package.

As in JAX: the input is NHWC, compute in ``dtype`` (bf16 by default) with
f32 parameters and batch-norm statistics, the stride-2 3x3 conv inside the
bottleneck (v1.5), the last BN scale of each block initialised to zero,
max-pool 3x3/2 with padding 1, the mean over H and W, f32 logits.
Activations stay ``channels_last`` through the network, weights too.

Train and eval follow the module's mode (``model.train()``/``model.eval()``)
where the JAX model takes ``train=``. ``fold_bn=True`` is the
inference-only variant that takes ``fold_batchnorm``'s output; its forward
raises in train mode.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime.state import resolve_device
from .layers import BatchNorm, Conv, Dense, init_weights


def _identity_norm(num: int, scale_init: float = 1.0) -> nn.Module:
    """The norm of the ``fold_bn`` variant: absorbed into the conv."""
    return nn.Identity()


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) with a projection shortcut where the
    shape changes (ResNet-50/101)."""

    def __init__(self, cin: int, filters: int, stride: int, conv, norm
                 ) -> None:
        super().__init__()
        cout = filters * 4
        self.out_channels = cout
        self.Conv_0 = conv(cin, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, stride)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, cout, 1)
        self.BatchNorm_2 = norm(cout, scale_init=0.0)
        if stride != 1 or cin != cout:
            self.conv_proj = conv(cin, cout, 1, stride)
            self.norm_proj = norm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class BasicBlock(nn.Module):
    """Two 3x3 convs (ResNet-18/34)."""

    def __init__(self, cin: int, filters: int, stride: int, conv, norm
                 ) -> None:
        super().__init__()
        self.out_channels = filters
        self.Conv_0 = conv(cin, filters, 3, stride)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3)
        self.BatchNorm_1 = norm(filters, scale_init=0.0)
        if stride != 1 or cin != filters:
            self.conv_proj = conv(cin, filters, 1, stride)
            self.norm_proj = norm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """Configurable ResNet over NHWC inputs of 3 channels.

    ``stem``: ``"conv"`` (7x7/2, torchvision's) or ``"space_to_depth"``
    (2x2 space-to-depth into a 4x4 stride-1 conv, the MLPerf stem). Weights
    are random, drawn on ``device`` from ``seed``, or loaded with
    ``load_state_dict`` (e.g. from ``params_from_jax``).
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, stem: str = "conv",
                 fold_bn: bool = False, *, device=None, seed: int = 0
                 ) -> None:
        super().__init__()
        if stem not in ("conv", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}")
        dev = resolve_device(device)
        self.dtype = dtype
        self.stem = stem
        self.fold_bn = fold_bn
        self.num_blocks = sum(stage_sizes)
        self.block_name = block_cls.__name__
        conv = partial(Conv, bias=fold_bn, dtype=dtype, device=dev)
        norm = _identity_norm if fold_bn else \
            partial(BatchNorm, dtype=dtype, device=dev)
        if stem == "space_to_depth":
            self.conv_init_s2d = conv(12, num_filters, 4)
        else:
            self.conv_init = conv(3, num_filters, 7, 2)
        self.bn_init = norm(num_filters)
        cin = num_filters
        idx = 0
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                block = block_cls(cin, num_filters * 2 ** i,
                                  2 if i > 0 and j == 0 else 1, conv, norm)
                setattr(self, f"{self.block_name}_{idx}", block)
                cin = block.out_channels
                idx += 1
        self.head = Dense(cin, num_classes, dtype, dev)
        init_weights(self, seed)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: [B, H, W, 3] -> f32 logits [B, num_classes]."""
        if self.fold_bn and self.training:
            raise ValueError("fold_bn=True is an inference-only variant; "
                             "call .eval() first")
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
            stem = self.conv_init_s2d
        else:
            stem = self.conv_init
        x = x.permute(0, 3, 1, 2)          # NHWC memory = channels_last NCHW
        x = F.relu(self.bn_init(stem(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.num_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x)
        x = x.mean(dim=(2, 3))
        return self.head(x).float()


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
