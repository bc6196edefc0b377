"""The parallel layer: attention (the dense oracle, flash attention as
hand-written CUDA kernels with plain PyTorch twins, and ring and Ulysses
context parallelism over the ranks), context-parallel LM execution, the
chunked LM loss, the Switch mixture of experts (dense, and expert
parallel over the ranks), Megatron tensor parallelism over a model group
and GPipe pipeline parallelism over the stages of a group."""

from .context import (
    reference_attention,
    ring_attention,
    ring_attention_shard,
    ulysses_attention,
    ulysses_attention_shard,
)
from .expert import (
    SwitchFFN,
    ep_apply,
    ep_lm_apply,
    ep_lm_init,
    ep_lm_loss_fn,
    ep_place_params,
    load_balance_loss,
    moe_param_specs,
    switch_dispatch,
)
from .flash import (
    flash_attention,
    flash_block,
    flash_block_bwd,
    launch_counts,
    reset_launch_counts,
)
from .lm import chunked_ce_loss, cp_apply, cp_loss_fn
from .pipeline import (
    pp_apply,
    pp_forward_fn,
    pp_loss_fn,
    pp_place_params,
    pp_stack_params,
    pp_train_init,
    pp_train_step_fn,
)
from .tensor import LM_TP_RULES, tp_apply, tp_loss_fn, tp_shard_params

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
    "switch_dispatch",
    "ep_apply",
    "ep_place_params",
    "moe_param_specs",
    "ep_lm_init",
    "ep_lm_apply",
    "ep_lm_loss_fn",
    "LM_TP_RULES",
    "tp_shard_params",
    "tp_apply",
    "tp_loss_fn",
    "pp_stack_params",
    "pp_place_params",
    "pp_forward_fn",
    "pp_loss_fn",
    "pp_train_init",
    "pp_train_step_fn",
    "pp_apply",
]
