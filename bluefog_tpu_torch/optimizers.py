"""Distributed optimizer wrappers — the training-loop layer.

Counterpart of ``_FusedOptimizer`` and its fused kinds in
``bluefog_tpu/optimizers.py`` (:270-404). Each ``step(batch)`` runs, in the
order of ``build_fused_step`` (:179-204):

    loss and backward  ->  torch.optim update  ->  communication

where the communication is, per wrapper:

  * ``DistributedGradientAllreduceOptimizer``: average the GRADIENTS before
    the update (Horovod style; reference optimizers.py:1026);
  * ``DistributedAllreduceOptimizer``: average the PARAMETERS after it
    (reference optimizers.py:895);
  * ``DistributedNeighborAllreduceOptimizer``: the weighted neighbor combine
    of the PARAMETERS over the virtual topology (reference
    optimizers.py:943) — the flagship decentralized step.

All parameters ride one flat fusion buffer, so a combine costs one send per
shift. ``num_steps_per_communication=k`` communicates on every k-th step
only (local SGD; reference optimizers.py:152-155).

Only the optimizer's parameters (``optimizer.param_groups``) are
communicated. A model's buffers — the BatchNorm ``mean``/``var`` of the
vision models — stay local to each rank, updated by its own forward passes
and never combined, as the JAX step returns each rank's ``batch_stats``
uncombined (``with_model_state=True``, ``bluefog_tpu/optimizers.py:179-204``).

Usage::

    opt = bf.DistributedNeighborAllreduceOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), model, loss_fn)
    metrics = opt.step(batch)      # loss_fn(model, batch) -> scalar loss
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from .ops import fusion as _fusion
from .ops.neighbors import neighbor_plan
from .ops.plan import CombinePlan, spmd_combine
from .runtime.state import _global_state


class _FusedOptimizer:
    """Shared machinery: local step, then one fused communication."""

    _comm_kind = "none"  # gradient_allreduce | allreduce |
    #                      neighbor_allreduce | none

    def __init__(self, optimizer: torch.optim.Optimizer, model: nn.Module,
                 loss_fn: Callable, *,
                 num_steps_per_communication: int = 1) -> None:
        st = _global_state()
        st.check_initialized()
        self.base = optimizer
        self.model = model
        self.loss_fn = loss_fn
        self.num_steps_per_communication = int(num_steps_per_communication)
        self._counter = 0
        self._params: List[nn.Parameter] = [
            p for g in optimizer.param_groups for p in g["params"]]

    def _plan(self) -> Optional[CombinePlan]:
        return None

    def _average(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Global mean of ``tensors`` through one fused all_reduce."""
        st = _global_state()
        spec = _fusion.make_spec(tensors)
        flat = _fusion.pack(tensors, spec)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        return _fusion.unpack(flat / st.size, spec)

    def _combine(self, tensors: List[torch.Tensor],
                 plan: CombinePlan) -> List[torch.Tensor]:
        st = _global_state()
        spec = _fusion.make_spec(tensors)
        flat = _fusion.pack(tensors, spec)
        (out,) = spmd_combine(plan.weight_array(), [flat], rank=st.rank,
                              n=plan.n, shifts=plan.shifts,
                              use_gather=plan.use_gather)
        return _fusion.unpack(out, spec)

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One training iteration of this rank; returns ``{"loss": ...}``."""
        self._counter += 1
        do_comm = self._counter % self.num_steps_per_communication == 0
        kind = self._comm_kind if do_comm else "none"
        plan = self._plan() if kind == "neighbor_allreduce" else None

        self.base.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.model, batch)
        loss.backward()
        if kind == "gradient_allreduce":
            live = [p for p in self._params if p.grad is not None]
            with torch.no_grad():
                for p, g in zip(live, self._average([p.grad for p in live])):
                    p.grad.copy_(g)
        self.base.step()
        if kind in ("allreduce", "neighbor_allreduce"):
            with torch.no_grad():
                ps = [p.detach() for p in self._params]
                new = self._average(ps) if kind == "allreduce" else \
                    self._combine(ps, plan)
                for p, v in zip(ps, new):
                    p.copy_(v)
        return {"loss": loss.detach()}


class DistributedGradientAllreduceOptimizer(_FusedOptimizer):
    """Global gradient averaging before the update (Horovod style)."""

    _comm_kind = "gradient_allreduce"


class DistributedAllreduceOptimizer(_FusedOptimizer):
    """Global parameter averaging after the local update."""

    _comm_kind = "allreduce"


class DistributedNeighborAllreduceOptimizer(_FusedOptimizer):
    """Parameter averaging with in-neighbors over the virtual topology.

    Mutate ``self_weight`` / ``neighbor_weights`` / ``send_neighbors``
    between steps for dynamic topologies (reference: optimizers.py:298-304);
    each distinct set of arguments builds its plan once and is cached.
    """

    _comm_kind = "neighbor_allreduce"

    def __init__(self, *args, **kw) -> None:
        super().__init__(*args, **kw)
        self.self_weight = None
        self.neighbor_weights = None
        self.send_neighbors = None
        self.enable_topo_check: bool = True

    def _plan(self) -> CombinePlan:
        return neighbor_plan(self.self_weight, self.neighbor_weights,
                             self.send_neighbors, self.enable_topo_check)
