"""The torch frontend: BlueFog's torch API for a user's own training loop.

Counterpart of ``bluefog_tpu/torch/__init__.py`` (the reference's
``bluefog.torch``: torch/mpi_ops.py, torch/utility.py, torch/optimizers.py).
The JAX frontend bridges torch tensors holding THIS controller's rank rows
onto its rank-stacked SPMD arrays and back. The port runs one process per
rank, and its ops already take and return this rank's torch tensor, so
the frontend's ops are the port's own functions, re-exported: the
collectives (``allreduce``, ``neighbor_allreduce``, ``broadcast``,
``allgather``, ``neighbor_allgather``, with the reference's
dynamic-topology keywords) and the one-sided ``win_*`` family.

The hooks a torch loop calls take modules, as the JAX frontend's do:
``broadcast_parameters`` and ``broadcast_optimizer_state`` overwrite this
rank's module parameters and their optimizer state with ``root_rank``'s, in
place (``utils/params.py`` does the work), and
:class:`DistributedTorchOptimizer` wraps a ``torch.optim`` optimizer and
mixes the parameters with the in-neighbours after its ``step()``::

    opt = DistributedTorchOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), model)
    for batch in data:
        opt.zero_grad()
        loss_fn(model, batch).backward()
        opt.step()

Absent on purpose: ``to_jax``/``to_torch`` (the port never imports JAX;
``utils/interop.py`` takes weights as numpy), the optimizer's
``device_resident`` (dlpack views into JAX-owned buffers), and
``utils/local_view.py``'s ``to_global``/``to_local``, which move
rank-stacked arrays between a controller and the mesh: with one rank per
process there is nothing to move. ``owned_ranks`` is
``runtime/control_plane.py``'s: this process's ``[rank]``.
"""

from __future__ import annotations

import types
from typing import List

import torch
from torch import nn

from .ops import (allgather, allreduce, broadcast, neighbor_allgather,
                  neighbor_allreduce, win_accumulate, win_create, win_free,
                  win_get, win_put, win_update, win_update_then_collect)
from .ops.neighbors import neighbor_plan
from .optimizers import fused_combine
from .runtime import flight as _flight
from .runtime import metrics as _metrics
from .runtime.control_plane import owned_ranks
from .runtime.state import _global_state
from .runtime.timeline import timeline_context
from .utils import params as _params

__all__ = [
    "owned_ranks",
    "allreduce", "neighbor_allreduce", "broadcast",
    "allgather", "neighbor_allgather", "win_create", "win_put", "win_get",
    "win_accumulate", "win_update", "win_update_then_collect", "win_free",
    "broadcast_parameters", "broadcast_optimizer_state",
    "DistributedTorchOptimizer",
]


def _module_params(modules) -> List[nn.Parameter]:
    """The parameters of ``modules`` (this rank's module, or a list of this
    rank's modules), each once, in ``parameters()`` order."""
    if isinstance(modules, nn.Module):
        modules = [modules]
    seen, out = set(), []
    for m in modules:
        for p in m.parameters():
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
    return out


def broadcast_parameters(modules, root_rank: int = 0) -> None:
    """Overwrite this rank's module parameters with ``root_rank``'s, in
    place (reference: torch/utility.py broadcast_parameters)."""
    _params.broadcast_parameters(_module_params(modules), root_rank)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer, modules,
                              root_rank: int = 0) -> None:
    """Overwrite the optimizer state of this rank's module parameters with
    ``root_rank``'s, in place (reference: torch/utility.py:137-230). The
    state of the optimizer's other parameters is left as it is. Every
    state tensor, 0-dim ones such as Adam's ``step`` too, stays its own
    tensor: nothing is aliased across parameters."""
    view = types.SimpleNamespace(
        param_groups=[{"params": _module_params(modules)}],
        state=optimizer.state)
    _params.broadcast_optimizer_state(view, root_rank)


class DistributedTorchOptimizer:
    """Decentralized wrapper of a torch optimizer for a user's own loop.

    The reference's ``DistributedNeighborAllreduceOptimizer`` for torch
    (torch/optimizers.py): every ``num_steps_per_communication``-th
    ``step()`` runs the wrapped optimizer's step, then averages this rank's
    parameters with its in-neighbours under the current topology. The
    mixing is one fused combine of every parameter of ``modules`` (this
    rank's module, or a list of this rank's modules) over the plan that
    ``DistributedNeighborAllreduceOptimizer`` builds, so it costs one send
    per shift. Set ``self_weight`` / ``neighbor_weights`` /
    ``send_neighbors`` (the JAX package's global form) between steps for a
    dynamic topology. ``zero_grad`` and every other attribute pass through
    to the wrapped optimizer.

    Each ``step`` records as the port's fused optimizers do: a ``STEP``
    timeline activity under the optimizer's class name with the mixing's
    ``NEIGHBOR_ALLREDUCE`` inside it, the ``opt.step_sec`` histogram, the
    flight recorder's ``opt.step`` span and the ``opt.step`` gauge.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, modules,
                 num_steps_per_communication: int = 1) -> None:
        _global_state().check_initialized()
        self.optimizer = optimizer
        self.modules = [modules] if isinstance(modules, nn.Module) \
            else list(modules)
        self.num_steps_per_communication = int(num_steps_per_communication)
        self.name = type(self).__name__
        self._counter = 0
        self._params = _module_params(self.modules)
        # dynamic-topology knobs, the surface of the port's optimizers
        self.self_weight = None
        self.neighbor_weights = None
        self.send_neighbors = None

    def zero_grad(self, *a, **k):
        return self.optimizer.zero_grad(*a, **k)

    def step(self, *a, **k):
        self._counter += 1
        try:
            with timeline_context(self.name, "STEP"), \
                    _metrics.timed("opt.step_sec"), \
                    _flight.recorder().span("opt.step", b=self._counter):
                out = self.optimizer.step(*a, **k)
                if self._counter % self.num_steps_per_communication == 0:
                    self._mix()
        except Exception as exc:
            _flight.fatal("opt.step", exc)
            raise
        _metrics.gauge("opt.step").set(self._counter)
        return out

    def _mix(self) -> None:
        plan = neighbor_plan(self.self_weight, self.neighbor_weights,
                             self.send_neighbors, op_name=self.name)
        with torch.no_grad(), \
                timeline_context(self.name, "NEIGHBOR_ALLREDUCE"):
            ps = [p.detach() for p in self._params]
            for p, v in zip(ps, fused_combine(ps, plan)):
                p.copy_(v)

    def __getattr__(self, name):  # passthrough (param_groups, state, ...)
        if "optimizer" not in self.__dict__:
            # e.g. unpickling probes dunders before __init__ ran; a plain
            # AttributeError here instead of infinite __getattr__ recursion
            raise AttributeError(name)
        return getattr(self.optimizer, name)
