"""Carry weights across from the JAX package.

``params_from_jax`` turns a flax variable tree — given as nested dicts of
numpy arrays, so this module needs no JAX — into a ``state_dict`` for the
port's model of the same name (``TransformerLM`` dense or MoE, ``SwitchFFN``,
``ResNet*``, ``VGG*``, ``MLP``, ``LeNet5``). The tree is the bare ``params`` or
``{"params": ..., "batch_stats": ...}``:

  * ``<layer>/kernel`` of a Dense (``[in, out]``) -> ``<layer>.weight``
    (``[out, in]``, the transpose);
  * ``<layer>/kernel`` of a Conv (``[kh, kw, cin, cout]``) ->
    ``<layer>.weight`` (``[cout, cin, kh, kw]``);
  * ``embed/embedding`` -> ``embed.weight``;
  * ``<layer>/bias`` and ``<norm>/scale`` -> the parameter of that name;
  * a ``SwitchFFN``'s raw leaves, ``block_<i>/moe/{gate,up,down}`` in an
    MoE ``TransformerLM`` or ``{gate,up,down}`` of a bare ``SwitchFFN``
    tree -> ``block_<i>.moe.{gate,up,down}`` (resp. ``{gate,up,down}``),
    untransposed: they are parameters, not ``Dense`` kernels, and keep
    flax's ``[d, E]``, ``[E, d, d_ff]`` and ``[E, d_ff, d]`` layout;
  * ``batch_stats`` ``<norm>/mean`` and ``<norm>/var`` -> the buffers.

Any other leaf raises, so a renamed layer cannot slip through unmapped.
With ``expert_rank=r`` the tree's full ``[E, ...]`` experts go to an
expert-parallel model (``expert_axis`` set) on rank r of its group: each
expert-local leaf (``parallel.moe_param_specs``) keeps expert r alone, as
JAX's ``ep_lm_init`` followed by ``moe_param_specs`` shards them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..parallel.expert import _slice_experts


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _param(mods, leaf: str, arr: np.ndarray):
    if leaf == "kernel":
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        return ".".join(mods) + ".weight", arr
    if leaf == "embedding":
        return ".".join(mods) + ".weight", arr
    if leaf in ("scale", "bias"):
        return ".".join(mods) + "." + leaf, arr
    if leaf in ("gate", "up", "down") and mods[-1:] in ([], ["moe"]):
        return ".".join(mods + [leaf]), arr
    return None, arr


def params_from_jax(tree: Mapping, expert_rank: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """flax variables (nested dicts of arrays) -> a ``state_dict`` of f32
    CPU tensors for the port's model of the same architecture (with
    ``expert_rank``, its expert-parallel form on that rank)."""
    collections = {"params": tree}
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        collections = dict(tree)
    sd = {}
    for coll, sub in collections.items():
        for path, arr in _flatten(sub).items():
            *mods, leaf = path
            if coll == "params":
                name, arr = _param(mods, leaf, arr)
            elif leaf in ("mean", "var"):
                name = ".".join(mods) + "." + leaf
            else:
                name = None
            if name is None:
                raise KeyError(f"unmapped flax {coll} leaf {'/'.join(path)}")
            sd[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return sd if expert_rank is None else _slice_experts(sd, expert_rank)
