"""Layers of the vision models: flax's ``Conv``, ``BatchNorm`` and ``Dense``.

Counterparts of ``nn.Conv``, ``nn.BatchNorm`` and ``nn.Dense`` as
``bluefog_tpu/models/{resnet,vgg,mlp}.py`` use them, with flax's numerics
and parameter names so ``utils.interop.params_from_jax`` maps one to one:

  * every weight is f32 and is cast, with the input, to the compute
    ``dtype`` before the product (``dtype=bf16, param_dtype=f32``);
  * ``Conv`` weights are ``[cout, cin, kh, kw]``; activations are NCHW
    tensors in ``channels_last`` memory (an NHWC array permuted), so the
    convolutions run on cuDNN's NHWC tensor-core path;
  * ``BatchNorm`` normalises with the batch's biased variance reduced in
    f32 and moves its ``mean``/``var`` buffers as flax does,
    ``0.9 * old + 0.1 * batch`` (``torch.nn.BatchNorm2d`` would feed the
    unbiased variance into its running variance).

``classification_loss`` is the loss of the root ``bench.py`` (:72-83).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# flax's BatchNorm as the JAX models build it: one value for every norm;
# ``fold.py`` folds with the same epsilon
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


class Conv(nn.Module):
    """2-D convolution, f32 weight ``[cout, cin, k, k]``, product in ``dtype``.

    Padding is ``((k-1)//2, k//2)`` on each spatial side, as the JAX ResNet
    sets it (``resnet.py:108-120``): symmetric for odd kernels (and equal to
    ``"SAME"`` at stride 1, the padding of the JAX VGG and LeNet5),
    asymmetric for the 4x4 space-to-depth stem.
    """

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = False, dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.pad = ((kernel - 1) // 2, kernel // 2)
        self.weight = nn.Parameter(torch.empty(
            cout, cin, kernel, kernel, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            cout, dtype=torch.float32, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.pad
        pad = lo
        if lo != hi:
            x = F.pad(x, (lo, hi, lo, hi))
            pad = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.stride, pad)


class BatchNorm(nn.Module):
    """Batch norm over NCHW, flax semantics (``BN_MOMENTUM``, ``BN_EPS``).

    Train mode normalises with the batch statistics and updates the
    buffers; eval mode normalises with the buffers. Statistics and the
    affine run in f32 and the output is in the input's dtype, as flax's
    ``force_float32_reductions``.
    """

    def __init__(self, num: int, dtype: torch.dtype = torch.float32,
                 scale_init: float = 1.0, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.full((num,), scale_init, **f32))
        self.bias = nn.Parameter(torch.zeros(num, **f32))
        self.register_buffer("mean", torch.zeros(num, **f32))
        self.register_buffer("var", torch.ones(num, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, BN_EPS)
        # the fused kernel returns the batch mean and 1/sqrt(var + eps) of
        # the biased variance; no running stats are passed, so it updates
        # none itself
        y, mu, invstd = torch.native_batch_norm(
            x, self.scale, self.bias, None, None, True, 0.0, BN_EPS)
        with torch.no_grad():
            var = (invstd.pow(-2) - BN_EPS).clamp_min_(0.0)
            m = BN_MOMENTUM
            self.mean.mul_(m).add_(mu, alpha=1.0 - m)
            self.var.mul_(m).add_(var, alpha=1.0 - m)
        return y


class Dense(nn.Module):
    """Dense layer with bias: f32 weight ``[out, in]``, product in ``dtype``."""

    def __init__(self, d_in: int, d_out: int,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            d_out, d_in, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            d_out, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Draw every ``Conv``/``Dense`` weight of ``model`` from a generator on
    its device seeded with ``seed``: normal with std 1/sqrt(fan_in), as the
    port's ``TransformerLM`` does. Biases stay 0, norms as constructed."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (Conv, Dense)):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, fan_in ** -0.5, generator=gen)


def nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W*C] in the JAX models' NHWC order (a view
    when ``x`` is ``channels_last``)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def classification_loss(model: nn.Module, batch) -> torch.Tensor:
    """Mean softmax cross-entropy of ``model(images)`` against integer
    ``labels`` for ``batch = (images, labels)``: the loss of the root
    ``bench.py`` (``optax.softmax_cross_entropy_with_integer_labels``
    averaged). uint8 images are normalised on their device as
    ``x / 127.5 - 1``."""
    images, labels = batch
    if images.dtype == torch.uint8:
        images = images.float() / 127.5 - 1.0
    return F.cross_entropy(model(images), labels.long())
