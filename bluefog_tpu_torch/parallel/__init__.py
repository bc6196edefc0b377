"""Attention for the parallel layer: the dense oracle and flash attention
(hand-written CUDA kernels with plain PyTorch twins)."""

from .context import reference_attention
from .flash import (
    flash_attention,
    flash_block,
    flash_block_bwd,
    launch_counts,
    reset_launch_counts,
)

__all__ = [
    "reference_attention",
    "flash_attention",
    "flash_block",
    "flash_block_bwd",
    "launch_counts",
    "reset_launch_counts",
]
