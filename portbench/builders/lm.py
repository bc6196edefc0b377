"""The LM cells' system: the port's ``TransformerLM`` with the flash kernels
(bf16 compute, f32 parameters) and ``models.lm_loss``, trained by
``DistributedNeighborAllreduceOptimizer`` around the cell's optimizer."""

from __future__ import annotations

import torch

from . import Job, base_optimizer, init_world, load

_LAYER = {"norm1": "RMSNorm_0.scale", "wqkv": "qkv.weight", "wo": "out.weight",
          "norm2": "RMSNorm_1.scale", "w_up": "up.weight",
          "w_down": "down.weight"}


def names(cfg: dict) -> dict:
    """Benchmark parameter name -> the port's parameter name."""
    out = {"embed": "embed.weight", "final_norm": "final_norm.scale",
           "lm_head": "lm_head.weight"}
    for i in range(int(cfg["num_hidden_layers"])):
        for ours, theirs in _LAYER.items():
            out[f"layers.{i}.{ours}"] = f"block_{i}.{theirs}"
    return out


def build(config: dict, job: dict, W: dict, device: torch.device) -> Job:
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.models import TransformerLM, lm_loss
    from bluefog_tpu_torch.optimizers import DistributedNeighborAllreduceOptimizer
    from bluefog_tpu_torch.parallel.flash import flash_attention

    init_world(job, device)
    model = TransformerLM(
        vocab_size=int(config["vocab_size"]),
        num_layers=int(config["num_hidden_layers"]),
        num_heads=int(config["num_attention_heads"]),
        d_model=int(config["hidden_size"]), d_ff=int(config["intermediate_size"]),
        dtype=torch.bfloat16, attn_fn=flash_attention, device=device, seed=0)
    mapping = names(config)
    load(model, W, mapping)
    params = dict(model.named_parameters())
    opt = DistributedNeighborAllreduceOptimizer(
        base_optimizer(model.parameters(), job["optimizer"]), model, lm_loss)
    return Job(opt=opt, leaves=[(b, params[p]) for b, p in mapping.items()],
               close=bf.shutdown)
