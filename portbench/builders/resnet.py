"""The vision cells' system: the port's ``ResNet`` of bottleneck blocks
(bf16 compute, f32 parameters and batch-norm statistics, ``channels_last``)
and ``models.classification_loss``, trained by
``DistributedNeighborAllreduceOptimizer`` around the cell's optimizer, with
cuDNN choosing its algorithms by timing them, as ``bluefog_tpu_torch.bench``
sets it."""

from __future__ import annotations

import torch

from . import Job, base_optimizer, init_world, load


def names(cfg: dict) -> dict:
    """Benchmark parameter name -> the port's parameter name."""
    out = {}

    def conv_bn(ours: str, conv: str, bn: str) -> None:
        out[f"{ours}.conv"] = f"{conv}.weight"
        out[f"{ours}.bn.scale"] = f"{bn}.scale"
        out[f"{ours}.bn.bias"] = f"{bn}.bias"

    conv_bn("stem", "conv_init", "bn_init")
    width = int(cfg["num_filters"])
    cin, k = width, 0
    for stage, count in enumerate(cfg["stage_sizes"]):
        filters = width * 2 ** stage
        for j in range(count):
            blk = f"BottleneckBlock_{k}"
            for c in range(3):
                conv_bn(f"blocks.{k}.c{c + 1}", f"{blk}.Conv_{c}",
                        f"{blk}.BatchNorm_{c}")
            if (stage > 0 and j == 0) or cin != 4 * filters:
                conv_bn(f"blocks.{k}.proj", f"{blk}.conv_proj", f"{blk}.norm_proj")
            cin, k = 4 * filters, k + 1
    out["fc.weight"] = "head.weight"
    out["fc.bias"] = "head.bias"
    return out


def build(config: dict, job: dict, W: dict, device: torch.device) -> Job:
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.models import BottleneckBlock, ResNet, classification_loss
    from bluefog_tpu_torch.optimizers import DistributedNeighborAllreduceOptimizer

    init_world(job, device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    model = ResNet(stage_sizes=config["stage_sizes"], block_cls=BottleneckBlock,
                   num_classes=int(config["num_classes"]),
                   num_filters=int(config["num_filters"]),
                   dtype=torch.bfloat16, device=device, seed=0)
    mapping = names(config)
    load(model, W, mapping)
    params = dict(model.named_parameters())
    opt = DistributedNeighborAllreduceOptimizer(
        base_optimizer(model.parameters(), job["optimizer"]), model,
        classification_loss)
    return Job(opt=opt, leaves=[(b, params[p]) for b, p in mapping.items()],
               close=bf.shutdown)
