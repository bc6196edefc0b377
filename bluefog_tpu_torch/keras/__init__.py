"""Keras 3 frontend on the torch backend.

Counterpart of ``bluefog_tpu/keras/__init__.py``, which runs on the Keras
JAX backend. The reference shipped a TensorFlow frontend
(tensorflow/optimizers.py:1-203); its users, people with Keras models and
Keras optimizers, get the reference's high-level surface here, on Keras's
torch backend, whose variables are torch tensors the port's collectives
move directly:

  * :func:`broadcast_variables`: the root rank's variables to every rank
    (reference tensorflow utility.py ``broadcast_variables``);
  * :class:`DistributedOptimizer`: the reference TF
    ``DistributedOptimizer`` (average the gradients across ranks before
    applying, optimizers.py:118-160) plus the decentralized mode
    (``communication_type="neighbor.allreduce"`` mixes the variables with
    the topology after each apply).

One process per rank, as the port's torch frontend: ``models`` is this
rank's model, or a list of one. Absent on purpose: the JAX frontend's
``device_resident`` rows and its ``_DevicePlan`` (jax arrays committed to
mesh devices); the variables here already are the tensors the collectives
take.

Requires ``KERAS_BACKEND=torch`` (import fails loudly otherwise), with the
runtime on the device Keras places its variables on. This package's
``__init__`` does not import this subpackage: Keras is an optional
dependency.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

import keras

from ..ops import fusion as _fusion
from ..ops.collectives import allreduce as _allreduce
from ..ops.collectives import broadcast as _broadcast
from ..ops.neighbors import neighbor_plan
from ..optimizers import fused_combine
from ..runtime.control_plane import owned_ranks as _owned_ranks

if keras.backend.backend() != "torch":  # pragma: no cover - env-dependent
    raise ImportError(
        "bluefog_tpu_torch.keras needs the Keras torch backend; set "
        "KERAS_BACKEND=torch before importing keras (got "
        f"'{keras.backend.backend()}')")

__all__ = ["broadcast_variables", "DistributedOptimizer"]


def _variables(models) -> List:
    """This rank's model's variables, trainable then non-trainable
    (positional: keras numbers layer names per model, so variable paths
    differ across structurally identical models)."""
    owned = _owned_ranks()
    if len(models) != len(owned):
        raise ValueError(
            f"need one model replica per rank this controller owns "
            f"({len(owned)}), got {len(models)}")
    (m,) = models
    return m.trainable_variables + m.non_trainable_variables


def _as_tensor(g, like: torch.Tensor) -> torch.Tensor:
    if not isinstance(g, torch.Tensor):
        g = torch.as_tensor(np.asarray(g))
    return g.to(device=like.device, dtype=like.dtype)


def broadcast_variables(models, root_rank: int = 0) -> None:
    """Overwrite this rank's model variables with ``root_rank``'s
    (reference: tensorflow utility.py broadcast_variables)."""
    if isinstance(models, keras.Model) or not isinstance(
            models, (list, tuple)):
        models = [models]
    vs = _variables(models)
    for v, o in zip(vs, _broadcast([v.value.detach() for v in vs],
                                   root_rank)):
        v.assign(o)


class DistributedOptimizer:
    """Wrap a keras optimizer with cross-rank communication.

    ``communication_type="allreduce"`` (default) averages the incoming
    gradients across ranks, in one fused all-reduce, before applying: the
    reference TF ``DistributedOptimizer`` (tensorflow/optimizers.py:118-160).
    Call :meth:`apply_stacked` with one gradient list (this rank's), or
    :meth:`apply_gradients` with ``(gradient, variable)`` pairs.

    ``communication_type="neighbor.allreduce"`` applies the local gradients
    untouched and then mixes every variable with the rank's in-neighbors
    under the current topology, in one fused combine
    (``optimizers.fused_combine``): the decentralized family the reference
    only offered on torch.

    Both communicate on every ``num_steps_per_communication``-th call only,
    with local steps in between. ``optimizer`` is a keras optimizer, a
    zero-argument factory of one, or a list of one per model.
    """

    def __init__(self, optimizer, models,
                 communication_type: str = "allreduce",
                 num_steps_per_communication: int = 1) -> None:
        if isinstance(models, keras.Model):
            models = [models]
        if communication_type not in ("allreduce", "neighbor.allreduce"):
            raise ValueError(f"unknown communication_type "
                             f"'{communication_type}'")
        self.models = list(models)
        # a keras optimizer binds to the variables it was built with: one
        # instance per model
        if callable(optimizer) and not isinstance(
                optimizer, keras.optimizers.Optimizer):
            self.optimizers = [optimizer() for _ in self.models]
        elif isinstance(optimizer, (list, tuple)):
            if len(optimizer) != len(self.models):
                raise ValueError("need one optimizer per model replica")
            self.optimizers = list(optimizer)
        elif len(self.models) == 1:
            self.optimizers = [optimizer]
        else:
            raise ValueError(
                "pass a zero-arg optimizer factory (e.g. lambda: "
                "keras.optimizers.SGD(0.1)) or one optimizer per replica "
                "— a single keras optimizer cannot drive several models")
        self.communication_type = communication_type
        self.num_steps_per_communication = num_steps_per_communication
        self._counter = 0

    @property
    def optimizer(self):
        return self.optimizers[0]

    def apply_stacked(self, grads_per_rank: List[list]) -> None:
        """Apply this rank's gradient list (a list of one list).

        allreduce mode: the gradients are rank-averaged first (the TF
        reference's semantic); neighbor mode: applied locally, then the
        variables mix. Gradients are numpy arrays or tensors, in
        ``trainable_variables`` order.
        """
        if len(grads_per_rank) != len(self.models):
            raise ValueError("need one gradient list per model replica")
        vs = _variables(self.models)
        self._counter += 1
        communicate = \
            self._counter % self.num_steps_per_communication == 0
        tvs = self.models[0].trainable_variables
        grads = [_as_tensor(g, v.value)
                 for g, v in zip(grads_per_rank[0], tvs)]
        if communicate and self.communication_type == "allreduce":
            spec = _fusion.make_spec(grads)
            grads = _fusion.unpack(
                _allreduce(_fusion.pack(grads, spec), average=True), spec)
        self.optimizers[0].apply_gradients(zip(grads, tvs))
        if communicate and self.communication_type == "neighbor.allreduce":
            mixed = fused_combine([v.value.detach() for v in vs],
                                  neighbor_plan())
            for v, x in zip(vs, mixed):
                v.assign(x)

    def apply_gradients(self, grads_and_vars) -> None:
        """Single-replica convenience; multi-replica callers must use
        :meth:`apply_stacked` (a raw per-replica apply would bypass the
        cross-rank communication silently)."""
        if len(self.models) != 1:
            raise RuntimeError(
                "apply_gradients on a multi-replica DistributedOptimizer "
                "would skip communication; use apply_stacked with one "
                "gradient list per replica")
        pairs = list(grads_and_vars)
        self.apply_stacked([[g for g, _ in pairs]])

    def __getattr__(self, name):  # passthrough (learning_rate, ...)
        if "optimizers" not in self.__dict__:
            # unpickling probes dunders before __init__ ran; raise rather
            # than recurse through self.optimizers
            raise AttributeError(name)
        return getattr(self.optimizers[0], name)
