"""Plain float32 reference of the ResNet v1.5 configurations.

He et al. (arXiv:1512.03385) with the v1.5 change that MLPerf trains: a
7x7/2 stem convolution, batch norm and ReLU, a 3x3/2 max-pool with padding
1, then bottleneck blocks (1x1, 3x3 carrying the stage's stride, 1x1 to
four times the width), each convolution followed by batch norm, a
projection (1x1 convolution and batch norm) where the shape changes, ReLU
after the sum; the mean over the image, a classifier with bias, and the
mean cross-entropy. Batch norm normalises with the batch's biased variance
(``bn_eps``), as in training. Convolutions pad (k - 1) // 2 on each side.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import data, weights
from . import combine, lowp, train


def _blocks(cfg: dict):
    """(name, cin, filters, stride) of every bottleneck block."""
    cin = width = int(cfg["num_filters"])
    k = 0
    for stage, count in enumerate(cfg["stage_sizes"]):
        filters = width * 2 ** stage
        for j in range(count):
            yield f"blocks.{k}", cin, filters, 2 if stage > 0 and j == 0 else 1
            cin = 4 * filters
            k += 1


def _conv_spec(name: str, cin: int, cout: int, k: int) -> List[weights.Spec]:
    return [(f"{name}.conv", (cout, cin, k, k), ("normal", (2.0 / (cin * k * k)) ** 0.5)),
            (f"{name}.bn.scale", (cout,), ("ones",)),
            (f"{name}.bn.bias", (cout,), ("zeros",))]


def param_specs(cfg: dict) -> List[weights.Spec]:
    width = int(cfg["num_filters"])
    specs = _conv_spec("stem", 3, width, 7)
    for name, cin, filters, stride in _blocks(cfg):
        specs += _conv_spec(f"{name}.c1", cin, filters, 1)
        specs += _conv_spec(f"{name}.c2", filters, filters, 3)
        specs += _conv_spec(f"{name}.c3", filters, 4 * filters, 1)
        if stride != 1 or cin != 4 * filters:
            specs += _conv_spec(f"{name}.proj", cin, 4 * filters, 1)
        cin = 4 * filters
    classes = int(cfg["num_classes"])
    return specs + [("fc.weight", (classes, cin), ("normal", cin ** -0.5)),
                    ("fc.bias", (classes,), ("zeros",))]


def _conv_bn(x, W, name: str, stride: int, cfg: dict, precision: str):
    w = W[f"{name}.conv"]
    y = lowp.conv2d(x, w, precision, stride, (w.shape[-1] - 1) // 2)
    var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + float(cfg["bn_eps"]))
    y = y * W[f"{name}.bn.scale"][:, None, None] + W[f"{name}.bn.bias"][:, None, None]
    return lowp.act(y, precision)


def _stem(x, W, cfg: dict, precision: str):
    x = F.relu(_conv_bn(x, W, "stem", 2, cfg, precision))
    return F.max_pool2d(x, 3, 2, 1)


def _block(x, W, name: str, stride: int, cfg: dict, precision: str):
    y = F.relu(_conv_bn(x, W, f"{name}.c1", 1, cfg, precision))
    y = F.relu(_conv_bn(y, W, f"{name}.c2", stride, cfg, precision))
    y = _conv_bn(y, W, f"{name}.c3", 1, cfg, precision)
    if f"{name}.proj.conv" in W:
        x = _conv_bn(x, W, f"{name}.proj", stride, cfg, precision)
    return lowp.act(F.relu(x + y), precision)


def loss(W: Dict[str, torch.Tensor], batch, cfg: dict, precision: str):
    images, labels = batch
    x = images.permute(0, 3, 1, 2)                     # NHWC -> NCHW
    x = checkpoint(_stem, x, W, cfg, precision, use_reentrant=False)
    for name, _, _, stride in _blocks(cfg):
        x = checkpoint(_block, x, W, name, stride, cfg, precision,
                       use_reentrant=False)
    logits = lowp.linear(x.mean(dim=(2, 3)), W["fc.weight"], precision) + W["fc.bias"]
    return F.cross_entropy(logits, labels)


def readings(config: dict, job: dict, seed: int, device: torch.device,
             precision: str = "f32", steps: int = 3, rank: int = 0,
             world: int = 1) -> dict:
    """The reference's readings of ``steps`` steps of a cell from ``seed``,
    on ``rank`` of ``world``."""
    W = weights.generate(param_specs(config), seed, device)
    batches = data.make(config, job, seed, device, rank)[:steps]
    mean = combine.neighbour_mean(job["topology"], rank, world) \
        if world > 1 else None
    with train.strict_f32():
        return train.readings(
            partial(loss, cfg=config, precision=precision), W, batches,
            job["optimizer"], steps, mean)
