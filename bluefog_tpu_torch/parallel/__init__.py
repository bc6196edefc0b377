"""The parallel layer: attention (the dense oracle, flash attention as
hand-written CUDA kernels with plain PyTorch twins, and ring and Ulysses
context parallelism over the ranks), context-parallel LM execution, the
chunked LM loss and the Switch mixture of experts (dense mode)."""

from .context import (
    reference_attention,
    ring_attention,
    ring_attention_shard,
    ulysses_attention,
    ulysses_attention_shard,
)
from .expert import SwitchFFN, load_balance_loss
from .flash import (
    flash_attention,
    flash_block,
    flash_block_bwd,
    launch_counts,
    reset_launch_counts,
)
from .lm import chunked_ce_loss, cp_apply, cp_loss_fn

__all__ = [
    "reference_attention",
    "ring_attention",
    "ring_attention_shard",
    "ulysses_attention",
    "ulysses_attention_shard",
    "cp_apply",
    "cp_loss_fn",
    "flash_attention",
    "flash_block",
    "flash_block_bwd",
    "launch_counts",
    "reset_launch_counts",
    "chunked_ce_loss",
    "SwitchFFN",
    "load_balance_loss",
]
