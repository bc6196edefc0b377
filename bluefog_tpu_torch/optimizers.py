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
    optimizers.py:943) — the flagship decentralized step;
  * ``DistributedHierarchicalNeighborAllreduceOptimizer``: the mean of the
    PARAMETERS over each machine, then the neighbor combine of the
    machines' means over the machine graph (reference optimizers.py:971);

all four with every parameter in one flat fusion buffer, so a combine
costs one send per shift. ``num_steps_per_communication=k`` communicates on
every k-th step only (local SGD; reference optimizers.py:152-155).

``DistributedShardedAllreduceOptimizer`` is ZeRO-1 (JAX
``build_sharded_step``, :229-267): the gradients' mean through one
reduce-scatter, the update of this rank's 1/n flat shard, and one
all-gather of the parameters.

Only the optimizer's parameters (``optimizer.param_groups``) are
communicated. A model's buffers — the BatchNorm ``mean``/``var`` of the
vision models — stay local to each rank, updated by its own forward passes
and never combined, as the JAX step returns each rank's ``batch_stats``
uncombined (``with_model_state=True``, ``bluefog_tpu/optimizers.py:179-204``).

Each ``step`` records as the JAX ``_FusedOptimizer.step`` does
(:343-354): a ``STEP`` timeline activity under the optimizer's ``name``
(its class name by default), the ``opt.step_sec`` histogram, the flight
recorder's ``opt.step`` span with the step counter in ``b``, and the
``opt.step`` gauge once the step returns; an exception escaping the step
leaves a flight dump (``flight.fatal("opt.step", exc)``) and propagates.
The spans time the host's issue of the step's device work: no step waits
for the device.

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

from . import topology as topology_util
from .ops import fusion as _fusion
from .ops.collectives import _all_gather_flat, _reduce_scatter_flat
from .ops.neighbors import (_dynamic_weight_matrix, _uniform_weights,
                            hierarchical_start, neighbor_plan)
from .ops.plan import CombinePlan, spmd_combine
from .runtime import flight as _flight
from .runtime import metrics as _metrics
from .runtime.state import _global_state
from .runtime.timeline import timeline_context


class _FusedOptimizer:
    """Shared machinery: local step, then one fused communication."""

    _comm_kind = "none"  # gradient_allreduce | allreduce |
    #                      neighbor_allreduce | hierarchical | none

    def __init__(self, optimizer: torch.optim.Optimizer, model: nn.Module,
                 loss_fn: Callable, *,
                 num_steps_per_communication: int = 1,
                 name: Optional[str] = None) -> None:
        st = _global_state()
        st.check_initialized()
        self.base = optimizer
        self.model = model
        self.loss_fn = loss_fn
        self.num_steps_per_communication = int(num_steps_per_communication)
        self.name = name or type(self).__name__
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
        if self._comm_kind == "hierarchical":
            work, finish = hierarchical_start(plan, [flat])
            for req in work:
                req.wait()
            (out,) = finish()
        else:
            (out,) = spmd_combine(plan.weight_array(), [flat], rank=st.rank,
                                  n=plan.n, shifts=plan.shifts,
                                  use_gather=plan.use_gather)
        return _fusion.unpack(out, spec)

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One training iteration of this rank; returns ``{"loss": ...}``."""
        self._counter += 1
        do_comm = self._counter % self.num_steps_per_communication == 0
        kind = self._comm_kind if do_comm else "none"
        plan = self._plan() if kind in ("neighbor_allreduce",
                                        "hierarchical") else None
        try:
            with timeline_context(self.name, "STEP"), \
                    _metrics.timed("opt.step_sec"), \
                    _flight.recorder().span("opt.step", b=self._counter):
                loss = self._step(batch, kind, plan)
        except Exception as exc:
            # black-box dump before the stack unwinds: the ring's tail IS
            # the postmortem evidence (rate-limited; never raises)
            _flight.fatal("opt.step", exc)
            raise
        _metrics.gauge("opt.step").set(self._counter)
        return {"loss": loss.detach()}

    def _step(self, batch, kind: str,
              plan: Optional[CombinePlan]) -> torch.Tensor:
        """The step's work: loss and backward, update, communication."""
        self.base.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.model, batch)
        loss.backward()
        if kind == "gradient_allreduce":
            live = [p for p in self._params if p.grad is not None]
            with torch.no_grad():
                for p, g in zip(live, self._average([p.grad for p in live])):
                    p.grad.copy_(g)
        self.base.step()
        if kind in ("allreduce", "neighbor_allreduce", "hierarchical"):
            with torch.no_grad():
                ps = [p.detach() for p in self._params]
                new = self._average(ps) if kind == "allreduce" else \
                    self._combine(ps, plan)
                for p, v in zip(ps, new):
                    p.copy_(v)
        return loss


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


class DistributedHierarchicalNeighborAllreduceOptimizer(_FusedOptimizer):
    """The f32 mean of the parameters over each machine, then the neighbor
    combine of the machines' means over the machine graph, cast back once
    (reference: optimizers.py:971 and mpi_controller.cc:455-515; JAX
    ``build_fused_step`` :198-201).

    Set ``self_weight`` / ``neighbor_machine_weights`` /
    ``send_neighbor_machines`` (over machines, in the JAX package's global
    form) between steps for a dynamic machine graph; by default the
    machines average over Expo-2 with uniform weights.
    """

    _comm_kind = "hierarchical"

    def __init__(self, *args, **kw) -> None:
        _global_state().check_homogeneous()
        super().__init__(*args, **kw)
        self.self_weight: Optional[float] = None
        self.neighbor_machine_weights: Optional[Dict] = None
        self.send_neighbor_machines = None
        self.enable_topo_check: bool = False

    def _plan(self) -> CombinePlan:
        """JAX ``DistributedHierarchicalNeighborAllreduceOptimizer._plan``
        (:433-454)."""
        st = _global_state()
        m = st.size // st.local_size
        if self.send_neighbor_machines is None:
            if self.neighbor_machine_weights is not None:
                raise ValueError(
                    "neighbor_machine_weights requires send_neighbor_machines")
            mtopo = topology_util.ExponentialTwoGraph(m) if m > 1 else \
                topology_util.FullyConnectedGraph(1)
            W = _uniform_weights(mtopo, m)
        else:
            W = _dynamic_weight_matrix(
                m, self.send_neighbor_machines, self.self_weight,
                self.neighbor_machine_weights, self.enable_topo_check)
        return CombinePlan(W)


class DistributedShardedAllreduceOptimizer(_FusedOptimizer):
    """ZeRO-1: reduce-scatter the gradients, update this rank's shard of
    the flattened parameters, all-gather the parameters (JAX
    ``build_sharded_step``, :229-267, and ``_flat_shard``, :219-226).

    The parameters and their gradients live as views of two persistent flat
    buffers of ``ceil(total / n) * n`` elements, in ``model.parameters()``
    order, of the promotion of the parameters' dtypes (as ``ravel_pytree``
    promotes; a parameter of another dtype is copied in and out each step).
    Each step zeroes the gradient buffer, runs the backward into it,
    reduce-scatters it in place and divides by n, steps the optimizer on
    this rank's shard (itself a view of the parameter buffer) and
    all-gathers the shards in place: no pack or unpack pass runs.

    torch optimizers own their parameters, so the wrapper builds
    ``type(optimizer)`` anew over the one flat shard with the hyper-
    parameters of the given optimizer's one param group; ``self.base`` is
    that shard optimizer. The given optimizer must have one param group
    and no state yet. As in JAX, an elementwise optimizer (SGD, Adam, ...)
    takes the same steps as under ``DistributedGradientAllreduceOptimizer``;
    one that couples elements across tensors sees per-shard statistics.
    """

    _comm_kind = "sharded_allreduce"

    def __init__(self, optimizer: torch.optim.Optimizer, model: nn.Module,
                 loss_fn: Callable, *,
                 num_steps_per_communication: int = 1,
                 name: Optional[str] = None) -> None:
        super().__init__(
            optimizer, model, loss_fn,
            num_steps_per_communication=num_steps_per_communication,
            name=name)
        if self.num_steps_per_communication != 1:
            raise ValueError(
                "DistributedShardedAllreduceOptimizer requires "
                "num_steps_per_communication=1: a local step cannot update "
                "replicated params from sharded optimizer state")
        if len(optimizer.param_groups) != 1:
            raise ValueError(
                "DistributedShardedAllreduceOptimizer takes an optimizer with "
                "one param group: its shard has one set of hyper-parameters")
        if optimizer.state:
            raise ValueError(
                "DistributedShardedAllreduceOptimizer takes an optimizer with "
                "no state yet: the state is built over the flat shard")
        st = _global_state()
        params = self._params
        spec = _fusion.make_spec(params)
        n, total = st.size, spec.total
        shard = -(-total // n)
        dev = params[0].device
        self._flat_p = torch.zeros(shard * n, dtype=spec.buffer_dtype,
                                   device=dev)
        self._flat_g = torch.zeros_like(self._flat_p)
        self._grads, self._copied = [], []
        with torch.no_grad():
            for p, off in zip(params, spec.offsets):
                pv = self._flat_p[off:off + p.numel()].view(p.shape)
                gv = self._flat_g[off:off + p.numel()].view(p.shape)
                pv.copy_(p)
                if p.dtype == spec.buffer_dtype:
                    p.data = pv      # the parameter now lives in the buffer
                    self._grads.append((p, gv))
                else:
                    self._copied.append((p, pv, gv))
        lo = st.rank * shard
        self._shard = nn.Parameter(self._flat_p[lo:lo + shard])
        self._shard.grad = self._flat_g[lo:lo + shard]
        hp = {k: v for k, v in optimizer.param_groups[0].items()
              if k != "params"}
        self.base = type(optimizer)([{"params": [self._shard], **hp}])

    def _step(self, batch, kind: str,
              plan: Optional[CombinePlan]) -> torch.Tensor:
        """One ZeRO-1 iteration of this rank."""
        n = _global_state().size
        self._flat_g.zero_()
        for p, gv in self._grads:
            p.grad = gv        # backward accumulates into the flat buffer
        with torch.no_grad():
            for p, pv, _ in self._copied:
                p.grad = None
                pv.copy_(p)
        loss = self.loss_fn(self.model, batch)
        loss.backward()
        with torch.no_grad():
            for p, _, gv in self._copied:
                if p.grad is not None:
                    gv.copy_(p.grad)
            # in place: this rank's shard is the slice the scatter fills
            _reduce_scatter_flat(self._shard.grad, self._flat_g,
                                 op=dist.ReduceOp.SUM)
            self._shard.grad.div_(n)
            self.base.step()
            _all_gather_flat(self._flat_p, self._shard.detach())
            for p, pv, _ in self._copied:
                p.copy_(pv)
        return loss
