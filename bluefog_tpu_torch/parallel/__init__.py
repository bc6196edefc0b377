"""The parallel layer: attention (the dense oracle and flash attention,
hand-written CUDA kernels with plain PyTorch twins), the chunked LM loss and
the Switch mixture of experts (dense mode)."""

from .context import reference_attention
from .expert import SwitchFFN, load_balance_loss
from .flash import (
    flash_attention,
    flash_block,
    flash_block_bwd,
    launch_counts,
    reset_launch_counts,
)
from .lm import chunked_ce_loss

__all__ = [
    "reference_attention",
    "flash_attention",
    "flash_block",
    "flash_block_bwd",
    "launch_counts",
    "reset_launch_counts",
    "chunked_ce_loss",
    "SwitchFFN",
    "load_balance_loss",
]
