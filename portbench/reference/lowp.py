"""The products of a reference, in float32 or in float8.

``precision="fp8"`` rounds each product's operands and its result, and
each activation that ``act`` marks (the residual stream, a normalisation's
output), to float8 e4m3, and the gradient that reaches them to e5m2, each
scaled by its largest magnitude, and multiplies in float32: activations
pass from layer to layer in float8 where the configurations' programs hold
them in bf16. It is the precision below their bf16, which the output check
has to reject.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


def _round(x: torch.Tensor, fmt) -> torch.Tensor:
    dtype, top = fmt
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Operand(torch.autograd.Function):
    """Rounded to e4m3 forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, E4M3)

    @staticmethod
    def backward(ctx, g):
        return g


class _Result(torch.autograd.Function):
    """Rounded to e4m3 forward; the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, E4M3)

    @staticmethod
    def backward(ctx, g):
        return _round(g, E5M2)


def act(x, precision: str):
    """An activation as the configuration's programs hold it between
    operations: float32 here, e4m3 in the control."""
    if precision == "f32":
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    return _Result.apply(x)


def _low(fn, precision: str, *operands, **kw):
    if precision == "f32":
        return fn(*operands, **kw)
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    return _Result.apply(fn(*(_Operand.apply(t) for t in operands), **kw))


def linear(x, w, precision: str):
    """``x @ w.T``."""
    return _low(F.linear, precision, x, w)


def matmul(a, b, precision: str):
    return _low(torch.matmul, precision, a, b)


def conv2d(x, w, precision: str, stride: int, padding: int):
    return _low(F.conv2d, precision, x, w, stride=stride, padding=padding)
