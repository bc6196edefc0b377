"""Carry weights across from the JAX package.

``params_from_jax`` turns the flax ``TransformerLM`` parameter tree — given
as nested dicts of numpy arrays, so this module needs no JAX — into a
``state_dict`` for the port's ``TransformerLM``:

  * ``<layer>/kernel`` (flax Dense, ``[in, out]``) -> ``<layer>.weight``
    (``[out, in]``, the transpose);
  * ``embed/embedding`` -> ``embed.weight``;
  * ``<norm>/scale`` -> ``<norm>.scale``.

Any other leaf raises, so a renamed layer cannot slip through unmapped.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``TransformerLM`` params (nested dicts of arrays) -> a
    ``state_dict`` of f32 CPU tensors for the port's ``TransformerLM``."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    sd = {}
    for path, arr in _flatten(tree).items():
        *mods, leaf = path
        if leaf == "kernel":
            name, arr = ".".join(mods) + ".weight", arr.T
        elif leaf == "embedding":
            name = ".".join(mods) + ".weight"
        elif leaf == "scale":
            name = ".".join(mods) + ".scale"
        else:
            raise KeyError(f"unmapped flax parameter {'/'.join(path)}")
        sd[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return sd
