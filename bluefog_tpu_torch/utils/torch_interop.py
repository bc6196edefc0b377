"""Load torchvision-format ResNet and VGG weights into the port's models.

Counterpart of ``bluefog_tpu/utils/torch_interop.py``: ``resnet_from_torch``
(:50) and ``vgg_from_torch`` (:134) take a torchvision-format ``state_dict``
(``conv1.weight``, ``layer1.0.conv1.weight``, ..., ``fc.weight``; tensors or
arrays) and return a ``state_dict`` for the port's ``ResNet*``/``VGG*``,
whose names follow flax's tree (``conv_init.weight``,
``BasicBlock_0.Conv_0.weight``, ``...BatchNorm_0.scale/bias/mean/var``,
``head.weight``). The port's convolutions take ``[cout, cin, kh, kw]`` and
its dense layers ``[out, in]``, torchvision's layouts, so the tensors are
renamed, not transposed, but for VGG's first dense layer: torchvision
flattens the ``[512, 7, 7]`` map in CHW order, the port in NHWC's HWC order,
so the input axis of ``classifier.0.weight`` is permuted. Batch-norm
``weight``/``bias``/``running_mean``/``running_var`` become
``scale``/``bias``/``mean``/``var``; ``num_batches_tracked`` is dropped.

The errors read as JAX's: an unsupported depth, a checkpoint deeper than
the depth, a shallower one (a missing key).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..models.vgg import _CFGS as _VGG_CFGS

# stage layouts per torchvision depth: (stage_sizes, bottleneck?)
_LAYOUTS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
}


def _t(x) -> torch.Tensor:
    """An f32 CPU tensor of its own (a copy) of a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(x, np.float32))


def _bn(sd: Mapping, prefix: str, name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.scale": _t(sd[f"{prefix}.weight"]),
            f"{name}.bias": _t(sd[f"{prefix}.bias"]),
            f"{name}.mean": _t(sd[f"{prefix}.running_mean"]),
            f"{name}.var": _t(sd[f"{prefix}.running_var"])}


def _dense(sd: Mapping, prefix: str, name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _t(sd[f"{prefix}.weight"]),
            f"{name}.bias": _t(sd[f"{prefix}.bias"])}


def resnet_from_torch(state_dict: Mapping, depth: int
                      ) -> Dict[str, torch.Tensor]:
    """torchvision-format ResNet ``state_dict`` -> the port's ``ResNet``
    ``state_dict`` (``stem="conv"``). ``depth`` is 18/34/50/101::

        model = ResNet50(num_classes=...)
        model.load_state_dict(resnet_from_torch(torch_sd, 50))
    """
    if depth not in _LAYOUTS:
        raise ValueError(
            f"unsupported depth {depth}; choose {sorted(_LAYOUTS)}")
    stages, bottleneck = _LAYOUTS[depth]
    try:
        out = _convert_resnet(state_dict, stages, bottleneck)
    except KeyError as exc:
        raise ValueError(
            f"state_dict is missing {exc} — not a complete depth-{depth} "
            f"torchvision ResNet checkpoint; pass the matching depth"
        ) from None
    # a deeper checkpoint than `depth` would convert "cleanly" into
    # semantically wrong weights: make the mismatch loud instead
    leftover = [k for k in state_dict
                if k.startswith("layer") and "num_batches_tracked" not in k
                and not _consumed_layer_key(k, stages)]
    if leftover:
        raise ValueError(
            f"state_dict has blocks beyond a depth-{depth} ResNet "
            f"(e.g. {leftover[0]}); pass the matching depth")
    return out


def _convert_resnet(sd: Mapping, stages, bottleneck: bool
                    ) -> Dict[str, torch.Tensor]:
    block_name = "BottleneckBlock" if bottleneck else "BasicBlock"
    out = {"conv_init.weight": _t(sd["conv1.weight"]),
           **_bn(sd, "bn1", "bn_init")}
    idx = 0
    for stage, count in enumerate(stages, start=1):
        for b in range(count):
            src, dst = f"layer{stage}.{b}", f"{block_name}_{idx}"
            for c in range(3 if bottleneck else 2):
                out[f"{dst}.Conv_{c}.weight"] = _t(
                    sd[f"{src}.conv{c + 1}.weight"])
                out.update(_bn(sd, f"{src}.bn{c + 1}", f"{dst}.BatchNorm_{c}"))
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.conv_proj.weight"] = _t(
                    sd[f"{src}.downsample.0.weight"])
                out.update(_bn(sd, f"{src}.downsample.1", f"{dst}.norm_proj"))
            idx += 1
    out.update(_dense(sd, "fc", "head"))
    return out


def _consumed_layer_key(key: str, stages) -> bool:
    parts = key.split(".")
    stage = int(parts[0][len("layer"):])
    block = int(parts[1])
    return stage <= len(stages) and block < stages[stage - 1]


def vgg_from_torch(state_dict: Mapping, depth: int
                   ) -> Dict[str, torch.Tensor]:
    """torchvision-format VGG ``state_dict`` -> the port's ``VGG``
    ``state_dict``. ``depth`` is 11/16/19; the batch-norm variant is
    detected from the checkpoint (``features.<i>.running_mean``): build
    the port's model with ``batch_norm=False`` for a plain checkpoint, and
    at ``image_size=224`` (the 7x7 map ``classifier.0`` reads)::

        model = VGG16(num_classes=..., batch_norm=True)
        model.load_state_dict(vgg_from_torch(torch_sd, 16))
    """
    if depth not in _VGG_CFGS:
        raise ValueError(
            f"unsupported depth {depth}; choose {sorted(_VGG_CFGS)}")
    cfg = _VGG_CFGS[depth]
    batch_norm = any(k.endswith("running_mean") for k in state_dict
                     if k.startswith("features."))
    out: Dict[str, torch.Tensor] = {}
    t_idx = 0  # index into torchvision's features Sequential
    try:
        for i, v in enumerate(cfg):
            if v == "M":
                t_idx += 1
                continue
            conv = f"features.{t_idx}"
            w = _t(state_dict[f"{conv}.weight"])
            if w.dim() != 4 or w.shape[0] != v:
                raise ValueError(
                    f"{conv}.weight has shape {tuple(w.shape)}, expected {v} "
                    f"output channels — not a depth-{depth} checkpoint; "
                    "pass the matching depth")
            out[f"conv_{i}.weight"] = w
            out[f"conv_{i}.bias"] = _t(state_dict[f"{conv}.bias"])
            t_idx += 1
            if batch_norm:
                out.update(_bn(state_dict, f"features.{t_idx}", f"bn_{i}"))
                t_idx += 1
            t_idx += 1  # ReLU
        # classifier.0 reads torch's CHW flatten of [512, 7, 7]; the port
        # flattens NHWC -> HWC, so permute the input axis
        w0 = _t(state_dict["classifier.0.weight"])       # [4096, 512*7*7]
        out["fc_0.weight"] = w0.reshape(4096, 512, 7, 7).permute(
            0, 2, 3, 1).reshape(4096, 7 * 7 * 512).contiguous()
        out["fc_0.bias"] = _t(state_dict["classifier.0.bias"])
        out.update(_dense(state_dict, "classifier.3", "fc_1"))
        out.update(_dense(state_dict, "classifier.6", "head"))
    except KeyError as exc:
        raise ValueError(
            f"state_dict is missing {exc} — not a complete depth-{depth} "
            "torchvision VGG checkpoint; pass the matching depth"
        ) from None
    except (ValueError, RuntimeError) as exc:
        # a mis-declared depth walks t_idx onto the wrong module kind: keep
        # the diagnosis loud
        raise ValueError(
            f"state_dict does not match a depth-{depth} torchvision VGG "
            f"layout ({exc}); pass the matching depth") from None

    leftover = [k for k in state_dict
                if k.startswith("features.")
                and "num_batches_tracked" not in k
                and int(k.split(".")[1]) >= t_idx]
    if leftover:
        raise ValueError(
            f"state_dict has feature layers beyond a depth-{depth} VGG "
            f"(e.g. {leftover[0]}); pass the matching depth")
    return out
