"""Batch-norm folding for inference: absorb each BN into its conv.

Counterpart of ``bluefog_tpu/models/fold.py`` over the port's state dict.
At inference a BatchNorm is the affine ``(x - mean) * scale / sqrt(var +
eps) + bias``: its scale folds into the preceding conv's output channels
and its shift into a bias. Use with the ``fold_bn=True`` ResNet::

    folded = fold_batchnorm(model.state_dict())
    infer = ResNet50(fold_bn=True).eval()
    infer.load_state_dict(folded)
"""

from __future__ import annotations

from typing import Dict

import torch

from .layers import BN_EPS


def _norm_to_conv_name(norm_name: str, siblings) -> str:
    """Which conv a BN folds into, by the model zoo's naming contract
    (``bluefog_tpu/models/fold.py:46-56``)."""
    if norm_name.startswith("BatchNorm_"):
        return "Conv_" + norm_name.split("_", 1)[1]
    if norm_name == "norm_proj":
        return "conv_proj"
    if norm_name == "bn_init":
        for cand in ("conv_init", "conv_init_s2d"):
            if cand in siblings:
                return cand
    raise ValueError(f"no conv pairing rule for norm '{norm_name}'")


def fold_batchnorm(state_dict: Dict[str, torch.Tensor],
                   eps: float = BN_EPS) -> Dict[str, torch.Tensor]:
    """Fold every BatchNorm of ``state_dict`` into its preceding conv.

    Returns a new state dict for the ``fold_bn=True`` variant: the norms'
    ``scale``/``bias``/``mean``/``var`` are gone and each paired conv gains
    a ``bias``. The fold runs in float64 and returns f32. A module with a
    ``scale`` but no ``mean``/``var`` buffers, or a norm name with no
    pairing rule, raises rather than passing through unfolded.
    """
    norms = sorted({key[:-len(".scale")] for key in state_dict
                    if key.endswith(".scale")})
    missing = [n for n in norms
               if f"{n}.mean" not in state_dict or f"{n}.var" not in state_dict]
    if missing:
        raise ValueError(
            f"fold_batchnorm: norms {missing} have no mean/var buffers — "
            "pass the state dict of a model with batch norm")
    children: Dict[str, set] = {}       # module path -> its submodule names
    for key in state_dict:
        parent, _, mod = key.rpartition(".")[0].rpartition(".")
        children.setdefault(parent, set()).add(mod)

    out = dict(state_dict)
    for norm in norms:
        parent, _, name = norm.rpartition(".")
        conv = _norm_to_conv_name(name, children.get(parent, ()))
        conv = f"{parent}.{conv}" if parent else conv
        f64 = {k: out.pop(f"{norm}.{k}").double()
               for k in ("scale", "bias", "mean", "var")}
        inv = f64["scale"] / torch.sqrt(f64["var"] + eps)
        weight = state_dict[f"{conv}.weight"]
        out[f"{conv}.weight"] = (weight.double() * inv[:, None, None, None]
                                 ).float()
        out[f"{conv}.bias"] = (f64["bias"] - f64["mean"] * inv).float()
    return out
