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

The window optimizers (JAX ``_WindowOptimizer`` and its kinds, :530-1942)
take the local step, then gossip the parameters through the one-sided
windows of ``ops/windows.py``:

  * ``DistributedWinPutOptimizer``: put into the out-neighbours'
    mailboxes, then combine (reference optimizers.py:867);
  * ``DistributedPullGetOptimizer``: publish, pull the in-neighbours'
    rows, combine (reference optimizers.py:821);
  * ``DistributedPushSumOptimizer``: push-sum with the associated p
    (reference optimizers.py:776, 624-773).

Each heals around dead ranks and tuner-demoted edges, rotates a sharded
row (``BFT_WIN_SHARD``), serves and runs the quarantined rejoin, and
publishes serving snapshots (``BFT_SERVE_PUBLISH_EVERY``); their class
docstring says how.

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

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from . import topology as topology_util
from .ops import codec as _codec
from .ops import fusion as _fusion
from .ops import windows as _windows
from .ops.collectives import _all_gather_flat, _reduce_scatter_flat
from .ops.neighbors import (_dynamic_weight_matrix, _per_rank,
                            _uniform_weights, hierarchical_start,
                            neighbor_plan)
from .ops.plan import CombinePlan, spmd_combine
from .runtime import control_plane as _cp
from .runtime import flight as _flight
from .runtime import heartbeat as _hb
from .runtime import metrics as _metrics
from .runtime import timeseries as _timeseries
from .runtime import tuner as _tuner
from .runtime.config import knob_env
from .runtime.logging import logger
from .runtime.native import ControlPlaneClient, PeerLostError
from .runtime.state import _global_state
from .runtime.timeline import timeline_context

# Consensus-gauge cadence (seconds): the time-series sampler's ~1 Hz gate
_CONSENSUS_MIN_GAP = 0.9


def fused_combine(tensors: List[torch.Tensor], plan: CombinePlan, *,
                  hierarchical: bool = False) -> List[torch.Tensor]:
    """The combine of ``plan`` over ``tensors`` packed into one flat fusion
    buffer, so it costs one send per shift; returns the combined tensors
    (the torch frontend's ``DistributedTorchOptimizer`` runs it too)."""
    st = _global_state()
    spec = _fusion.make_spec(tensors)
    flat = _fusion.pack(tensors, spec)
    if hierarchical:
        work, finish = hierarchical_start(plan, [flat])
        for req in work:
            req.wait()
        (out,) = finish()
    else:
        (out,) = spmd_combine(plan.weight_array(), [flat], rank=st.rank,
                              n=plan.n, shifts=plan.shifts,
                              use_gather=plan.use_gather)
    return _fusion.unpack(out, spec)


class _FusedOptimizer:
    """Shared machinery: local step, then one fused communication."""

    _comm_kind = "none"  # gradient_allreduce | allreduce |
    #                      neighbor_allreduce | hierarchical | window | none

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
        return fused_combine(tensors, plan,
                             hierarchical=self._comm_kind == "hierarchical")

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


# ---------------------------------------------------------------------------
# Window (asynchronous gossip) optimizers
# ---------------------------------------------------------------------------

def _live_neighbor_sets(win, dead, demoted=frozenset()):
    """(live_out, live_in) neighbour maps of every rank with dead ranks and
    tuner-demoted directed edges left out."""
    n = win.size
    return ({r: [d for d in win.out_neighbors[r] if d not in dead
                 and (r, d) not in demoted]
             for r in range(n)},
            {r: [s for s in win.in_neighbors[r] if s not in dead
                 and (s, r) not in demoted]
             for r in range(n)})


def _healed_recv_weights(win, dead, self_weight, neighbor_weights,
                         demoted=frozenset()):
    """Combine weights of every rank over its LIVE in-neighbours.

    With both defaults (None) each rank takes the uniform
    ``1/(live_indegree + 1)``. User weights keep their shape: dead sources
    (and demoted edges, for the receiving rank's column only) drop out and
    the rest, self included, rescale by one factor so each rank's total
    weight is kept (``topology_util.prune_dead_ranks``' rule)."""
    n = win.size
    _, live_in = _live_neighbor_sets(win, dead, demoted)
    if self_weight is None and neighbor_weights is None:
        u = {r: 1.0 / (len(live_in[r]) + 1) for r in range(n)}
        return u, {r: {s: u[r] for s in live_in[r]} for r in range(n)}
    sw = _per_rank(self_weight, n, "self_weight")
    nw_table = _windows._edge_weights(neighbor_weights, win.in_neighbors,
                                      1.0, "neighbor_weights", n)
    out_sw, out_nw = {}, {}
    for r in range(n):
        total = float(sw[r]) + sum(nw_table[r].values())
        live = {s: w for s, w in nw_table[r].items()
                if s not in dead and (s, r) not in demoted}
        live_total = float(sw[r]) + sum(live.values())
        scale = total / live_total if live_total > 0 else 1.0
        out_sw[r] = float(sw[r]) * scale
        out_nw[r] = {s: w * scale for s, w in live.items()}
    return out_sw, out_nw


def _healed_send_table(win, dead, dst_weights, demoted=frozenset()):
    """Send weights with dead destinations and demoted edges dropped (no
    rescale: a put's send weights are per-edge multipliers, not a mass)."""
    n = win.size
    live_out, _ = _live_neighbor_sets(win, dead, demoted)
    if dst_weights is None:
        return {r: {d: 1.0 for d in live_out[r]} for r in range(n)}
    table = _windows._edge_weights(dst_weights, win.out_neighbors, 1.0,
                                   "dst_weights", n)
    return {r: {d: w for d, w in table[r].items()
                if d not in dead and (r, d) not in demoted}
            for r in range(n)}


def _halve(row: np.ndarray) -> np.ndarray:
    """``row * 0.5`` in the row's own dtype (bf16 rows are bit patterns):
    an exponent decrement, so the halves sum back bit for bit."""
    if row.dtype == _codec.BF16:
        return _codec.cast(_codec.to_f32(row) * np.float32(0.5), _codec.BF16)
    return row * np.asarray(0.5, row.dtype)


class _WindowOptimizer(_FusedOptimizer):
    """The local step, then the parameters' gossip through windows (JAX
    ``_WindowOptimizer``, ``bluefog_tpu/optimizers.py:599-1397``; reference
    ``_DistributedWinOptimizer``, optimizers.py:465-621).

    The constructor creates the windows (after ``bf.init()``): with
    ``BFT_FUSION_THRESHOLD`` > 0 one window over every parameter packed
    into one flat row in the widest dtype (one put+update pair a gossip
    step), else one window per parameter. ``BFT_WIN_SHARD=S`` makes the
    row one shard of the parameters (``ops/partition.py``'s piece table)
    and rotates the active shard each gossip step. A quarantined rejoiner
    adopts a live in-neighbour's state here, before its first step.

    Each ``step(batch)`` runs, in JAX's order: the local step; on the
    hosted plane the donor side of the rejoin protocol and the step-counter
    publish; PACK (the whole row or the active shard's); the gossip under
    one hoisted mutex acquisition, retried once over the healed tables on
    ``PeerLostError``; UNPACK (or the shard scatter) into the parameters in
    place; the ``opt.consensus_dist`` gauge; the serving snapshot; the
    time-series sample and the tuner's tick.

    The weight attributes are the JAX package's global forms
    (``self_weight`` a float or ``{rank: w}``, the others ``{rank: {peer:
    w}}`` or this rank's flat ``{peer: w}``); each op reads this rank's
    row. ``require_mutex`` (default True) takes the window mutexes on the
    hosted plane. The collective plane's rounds are lockstep, so no
    one-sided writer can race the step there: its gossip takes no hoisted
    acquisition (one process per rank would deadlock on JAX's lock of every
    rank), and its ops lock this rank's own mutex where one exists (a
    control plane, or a world of one).
    """

    _comm_kind = "window"
    _zero_init = False  # push-sum's mailboxes start empty
    # put/get record the neighbourhood consensus distance; push-sum's
    # numerator is p-biased (pushsum.debias_drift is its signal)
    _consensus_gauge = True

    _instance_counter = [0]

    def __init__(self, optimizer: torch.optim.Optimizer, model: nn.Module,
                 loss_fn: Callable, *,
                 num_steps_per_communication: int = 1,
                 name: Optional[str] = None,
                 window_prefix: Optional[str] = None) -> None:
        super().__init__(
            optimizer, model, loss_fn,
            num_steps_per_communication=num_steps_per_communication,
            name=name)
        _WindowOptimizer._instance_counter[0] += 1
        self._prefix = window_prefix or \
            f"{self.name}.{_WindowOptimizer._instance_counter[0]}"
        self._win_names: List[str] = []
        self.require_mutex = True
        # healed tables, rebuilt only when the dead (or demoted) set changes
        self._healed_cache: Dict[tuple, tuple] = {}
        self._serve_epoch: Optional[int] = None
        self._shard_factor = 1
        self._comm_rounds = 0
        self._rejoin_shards: Dict[Tuple[str, int], Dict[int, np.ndarray]] = {}
        self._consensus_t = 0.0
        self._serve_publisher = None
        self._serve_pub_dead = False
        self._create_windows()

    # -- windows --------------------------------------------------------------

    def _resolve_shard_factor(self) -> int:
        S = int(knob_env("BFT_WIN_SHARD") or 1)
        if S <= 1:
            return 1
        if not self._fused_pack:
            logger.warning(
                "BFT_WIN_SHARD=%d needs the fused window "
                "(BFT_FUSION_THRESHOLD > 0 packs the parameters into one "
                "flat row the partition can cut); running unsharded", S)
            return 1
        return S

    def _active_shard(self) -> int:
        return self._comm_rounds % self._shard_factor

    def _check_row_fits(self, spec) -> None:
        """A hosted window publishes its row and deposits it whole: refuse
        a raw row above the server's per-message ceiling, or a raw deposit
        above the mailbox cap, before any record ships."""
        st = _global_state()
        if not _windows._hosted_mode_enabled(
                st.win_plane or _windows._plane_policy()):
            return
        codec, _ = _codec.resolve_edge_spec(knob_env("BFT_WIN_CODEC"))
        elems = spec.shard.row_len if spec.shard is not None else spec.total
        nbytes = elems * _fusion.host_dtype(spec.buffer_dtype).itemsize
        ceiling = ControlPlaneClient._MAX_PAYLOAD
        cap = _cp.mailbox_cap_bytes()
        sends = bool(topology_util.out_neighbor_ranks(st.topology, st.rank))
        if codec is None and nbytes > ceiling:
            raise ValueError(
                f"{self.name}: a raw window row of {nbytes} bytes is above "
                f"the control plane's {ceiling}-byte per-message ceiling, "
                "so the hosted plane can neither publish nor deposit it; "
                "shard it (BFT_WIN_SHARD=S rows are ~1/S of it) or give it "
                "a codec (BFT_WIN_CODEC=int8 or fp8)")
        if codec is None and sends and cap > 0 and nbytes > cap:
            raise ValueError(
                f"{self.name}: a raw window row of {nbytes} bytes is above "
                f"the {cap}-byte mailbox cap, so no deposit of it can land; "
                "shard it (BFT_WIN_SHARD), give it a codec (BFT_WIN_CODEC) "
                "or raise BFT_CP_MAILBOX_MAX_MB")

    def _create_windows(self) -> None:
        """Pack the parameters and create the windows (JAX ``init``,
        :703-766), then run a pending quarantined rejoin."""
        params = self._params
        if knob_env("BFT_FUSION_THRESHOLD") > 0:
            self._groups = [list(range(len(params)))]
        else:
            self._groups = [[i] for i in range(len(params))]
        self._fused_pack = len(self._groups) == 1
        self._shard_factor = self._resolve_shard_factor()
        self._comm_rounds = 0
        shard_part = None
        if self._shard_factor > 1:
            from .ops import partition as _partition

            names = {id(p): n for n, p in self.model.named_parameters()}
            named = [(names.get(id(p), str(i)), p)
                     for i, p in enumerate(params)]
            floor_kb = knob_env("BFT_WIN_SHARD_FLOOR_KB") or 0.0
            shard_part = _partition.spec_for_tree(
                named, self._shard_factor,
                rules_spec=knob_env("BFT_WIN_SHARD_RULES"),
                floor_bytes=int(float(floor_kb) * 1024))
        self._specs = [
            _fusion.make_spec([params[i] for i in idxs], shard=shard_part)
            for idxs in self._groups]
        for spec in self._specs:
            self._check_row_fits(spec)
        self._win_names = [f"{self._prefix}.{gi}"
                           for gi in range(len(self._groups))]
        with torch.no_grad():
            for nm, idxs, spec in zip(self._win_names, self._groups,
                                      self._specs):
                group = [params[i].detach() for i in idxs]
                packed = _fusion.pack_shard(group, spec, 0) \
                    if self._shard_factor > 1 else _fusion.pack(group, spec)
                if not _windows.win_create(packed, nm,
                                           zero_init=self._zero_init):
                    raise RuntimeError(f"window {nm} already exists")
                if self._shard_factor > 1:
                    _windows._get_window(nm).bind_shard(self._shard_factor)
        if _hb.quarantine_pending():
            if _windows._get_window(self._win_names[0]).hosted:
                # adopt current state from a live in-neighbour (or the
                # newest checkpoint) BEFORE the first step, then publish
                # the quarantine's completion so survivors re-admit us
                self._rejoin_state_transfer()
            else:
                logger.warning(
                    "rejoin: collective-plane windows cannot transfer "
                    "state one-sidedly (every rank runs every exchange); "
                    "completing quarantine with fresh state")
            _hb.complete_quarantine()

    def ef_residual_norm(self) -> float:
        """L2 norm of the wire codec's error-feedback residuals held beside
        this optimizer's window(s) (0.0 without an error-feedback codec).
        A norm that grows without bound means the top-k fraction cannot
        keep up with the gradient scale."""
        total = 0.0
        for nm in self._win_names:
            total += _windows._get_window(nm).ef_residual_norm() ** 2
        return float(np.sqrt(total))

    def free(self) -> None:
        for nm in self._win_names:
            _windows.win_free(nm)
        self._win_names = []
        self._restore_flags()

    def _restore_flags(self) -> None:
        pass  # push-sum restores the associated-p toggle

    # -- the consensus gauge --------------------------------------------------

    def _consensus_self_weights(self, dead) -> Dict[int, float]:
        """Effective self weight of each owned rank (the user's scalar, else
        the live-in-degree default the healed tables use)."""
        win = _windows._get_window(self._win_names[0])
        sw = getattr(self, "self_weight", None)
        out: Dict[int, float] = {}
        for r in win.owned:
            live_in = [s for s in win.in_neighbors[r] if s not in dead]
            if not live_in:
                continue
            out[r] = float(sw) if sw is not None \
                else 1.0 / (len(live_in) + 1)
        return out

    def _record_consensus(self, packed, mixed) -> None:
        """``opt.consensus_dist`` from the pre/post-gossip rows, gated to
        the sampler's ~1 Hz: for combine weights that sum to 1,
        ``mixed - x = (1 - sw)(x_nbr - x)``, so the distance to the
        neighbourhood mean is ``|mixed - x| / (1 - sw)``. Never raises."""
        if not self._consensus_gauge or not self._win_names:
            return
        now = time.monotonic()
        if now - self._consensus_t < _CONSENSUS_MIN_GAP:
            return
        self._consensus_t = now
        try:
            sq = 0.0
            for a, b in zip(packed, mixed):
                d = b.float() - a.float()
                sq += float((d * d).sum())
            total, cnt = 0.0, 0
            for _, w in self._consensus_self_weights(
                    self._dead_ranks()).items():
                denom = 1.0 - w
                if denom <= 1e-9:
                    continue
                total += sq / (denom * denom)
                cnt += 1
            if cnt:
                _metrics.gauge("opt.consensus_dist").set(
                    float(np.sqrt(total / cnt)))
        except Exception as exc:  # noqa: BLE001 — gauge only
            logger.debug("consensus gauge skipped (%s)", exc)

    # -- the step -------------------------------------------------------------

    def _gossip(self, packed: List[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    def _mutex_ok(self, win) -> bool:
        """Whether the ops take their mutexes: ``require_mutex`` where the
        window has them."""
        return self.require_mutex and _windows._mutex_available(win)

    def _dead_ranks(self) -> set:
        """Ranks of dead controllers, read every gossip step (hosted plane
        only: on the collective plane every rank runs every exchange)."""
        win = _windows._get_window(self._win_names[0])
        if not win.hosted:
            return set()
        return _hb.dead_ranks()

    def _gossip_peers(self, win, owned, dead=frozenset()):
        """Remote ranks the put-family ops lock: write destinations."""
        return {d for s in owned for d in win.out_neighbors[s]
                if d not in dead}

    def _hoisted_mutex(self, name, dead=frozenset()):
        """One mutex acquisition around the whole gossip (the inner ops'
        acquires are then local depth bumps): hosted plane only."""
        win = _windows._get_window(name)
        if not self.require_mutex or not win.hosted:
            return contextlib.nullcontext()
        owned = set(win.owned)
        ranks = sorted(owned | self._gossip_peers(win, owned, dead))
        return _windows.win_mutex(name, ranks=ranks)

    def _step(self, batch, kind: str,
              plan: Optional[CombinePlan]) -> torch.Tensor:
        """The local step, then (on a communicating step) the gossip; the
        base ``step`` wraps it in the STEP spans and the flight dump of a
        failing step (``PeerLostError`` included once the retry is
        spent)."""
        fl = _flight.recorder()
        with fl.span("opt.local"):
            loss = super()._step(batch, "none", None)
        if kind == self._comm_kind:
            self._communicate(fl)
            _timeseries.maybe_sample()
            _tuner.maybe_tick()
        return loss

    def _communicate(self, fl) -> None:
        params = self._params
        win0 = _windows._get_window(self._win_names[0])
        if win0.hosted:
            # donor side of the rejoin (an epoch compare; the scan runs on
            # a change) and one KV put of the step counter
            self._serve_rejoin_requests()
            self._publish_step_counter()
        shard = -1
        with timeline_context(self.name, "PACK"), \
                _metrics.timed("opt.pack_sec"), fl.span("opt.pack"), \
                torch.no_grad():
            if self._shard_factor > 1:
                shard = self._active_shard()
                win0.set_active_shard(shard)
                packed = [_fusion.pack_shard([params[i] for i in idxs],
                                             spec, shard)
                          for idxs, spec in zip(self._groups, self._specs)]
            else:
                packed = [_fusion.pack([params[i].detach() for i in idxs],
                                       spec)
                          for idxs, spec in zip(self._groups, self._specs)]
        with _metrics.timed("opt.gossip_sec"), fl.span("opt.gossip"), \
                torch.no_grad():
            if self._fused_pack:
                # a PeerLostError here comes from the hoisted acquire,
                # before any data op: the retry recomputes the tables over
                # the updated dead set
                for attempt in (0, 1):
                    try:
                        with self._hoisted_mutex(self._win_names[0],
                                                 self._dead_ranks()):
                            mixed = self._gossip(packed)
                        break
                    except PeerLostError as exc:
                        if attempt:
                            raise
                        _metrics.counter("opt.gossip_retries").inc()
                        logger.warning(
                            "gossip step hit a dead peer (%s); retrying "
                            "once on the self-healed topology", exc)
            else:
                mixed = self._gossip(packed)
        with timeline_context(self.name, "UNPACK"), \
                _metrics.timed("opt.unpack_sec"), fl.span("opt.unpack"), \
                torch.no_grad():
            for idxs, spec, buf in zip(self._groups, self._specs, mixed):
                group = [params[i] for i in idxs]
                if shard >= 0:
                    _fusion.scatter_shard(group, buf, spec, shard)
                else:
                    for p, v in zip(group, _fusion.unpack(buf, spec)):
                        p.copy_(v)
            if shard >= 0:
                self._comm_rounds += 1
        if shard < 0:
            self._record_consensus(packed, mixed)
        # the serving plane: the post-gossip parameters as a snapshot
        self._maybe_publish_snapshot()

    # -- the serving plane --------------------------------------------------

    def _maybe_publish_snapshot(self) -> None:
        """On controller 0, every ``BFT_SERVE_PUBLISH_EVERY``-th
        communicating step: the post-gossip parameters as one versioned
        snapshot (version = the step counter, the codec the window's state
        codec unless ``BFT_SERVE_CODEC``). A failed publish never fails
        the step."""
        if self._serve_pub_dead:
            return
        try:
            every = int(knob_env("BFT_SERVE_PUBLISH_EVERY") or 0)
            if every <= 0:
                return
            if _cp.process_index() != 0 or not _cp.active():
                return
            if (self._counter // self.num_steps_per_communication) \
                    % every != 0:
                return
            if self._serve_publisher is None:
                from .serving.snapshot import (SnapshotPublisher,
                                               resolve_serve_codec)
                win = _windows._get_window(self._win_names[0])
                self._serve_publisher = SnapshotPublisher(
                    _cp.client(), codec=resolve_serve_codec(win.codec))
            stats = self._serve_publisher.publish(
                [p.detach() for p in self._params], self._counter,
                step=self._counter)
            _metrics.counter("serve.publishes").inc()
            _metrics.counter("serve.publish_wire_bytes").inc(
                int(stats["wire_bytes"]))
            _metrics.gauge("serve.version").set(int(stats["version"]))
            _metrics.gauge("serve.publish_sec").set(stats["seconds"])
        except (OSError, RuntimeError) as exc:
            logger.warning("serving-plane snapshot publish failed (%s); "
                           "version %d skipped", exc, self._counter)
        except Exception as exc:  # noqa: BLE001 — structural: disable
            self._serve_pub_dead = True
            logger.warning(
                "serving-plane publisher disabled for this run (%s)", exc)

    # -- the elastic rejoin ---------------------------------------------------
    #
    # A respawned rank attaches with a bumped incarnation (its zombie is
    # fenced server-side) and creates its windows QUARANTINED: registered,
    # kept out of averaging until it adopts current state. The transfer
    # reads a donor's published row under the donor's mutex (push-sum asks
    # the donor for a mass split instead) and adopts the donor
    # controller's step counter; the fallback is the newest checkpoint
    # under BFT_CHECKPOINT_DIR, the last resort fresh parameters.

    def _step_counter_key(self, pid: int) -> str:
        return f"bf.opt.{self._prefix}.step.{pid}"

    def _publish_step_counter(self) -> None:
        """A future rejoiner adopts this counter, so the communication
        cadence stays aligned after its transfer."""
        try:
            _cp.client().put(self._step_counter_key(_cp.process_index()),
                             self._counter)
        except (OSError, RuntimeError):
            pass

    def _serve_rejoin_requests(self) -> None:
        """Donor side, on a membership-epoch change (put and get transfer
        one-sidedly; push-sum's split needs the donor)."""

    def _donor_candidates(self, win, rank):
        """``rank``'s in-neighbours on other controllers, sorted."""
        owned = set(win.owned)
        return [s for s in win.in_neighbors[rank] if s not in owned]

    def _transfer_rank(self, rank: int, donor: int, deadline: float) -> bool:
        """Adopt ``donor``'s published rows as ``rank``'s, under the
        donor's window mutex so a publish cannot tear the read."""
        if self._shard_factor > 1:
            return self._transfer_rank_sharded(rank, donor, deadline)
        rows = []
        for nm in self._win_names:
            win = _windows._get_window(nm)
            try:
                with _windows.win_mutex(nm, ranks=[donor]):
                    row = win.read_published_row(donor)
            except (PeerLostError, OSError):
                return False
            if row is None:
                return False
            rows.append(row)
        for nm, row in zip(self._win_names, rows):
            _windows._get_window(nm).install_row(rank, row)
        return True

    def _transfer_rank_sharded(self, rank: int, donor: int,
                               deadline: float) -> bool:
        """A sharded donor publishes its active shard only and rotates one
        shard a gossip step: poll it across its steps until every shard is
        in hand, from this one donor (a failed donor's partial collection
        is dropped, never topped up by another's)."""
        ok = True
        for nm in self._win_names:
            win = _windows._get_window(nm)
            got: Dict[int, np.ndarray] = {}
            self._rejoin_shards[(nm, rank)] = got
            while len(got) < self._shard_factor and \
                    time.monotonic() < deadline:
                try:
                    with _windows.win_mutex(nm, ranks=[donor]):
                        row, sidx = win.read_published_shard(donor)
                except (PeerLostError, OSError):
                    return False
                if row is not None and sidx is not None and sidx not in got:
                    got[int(sidx)] = np.array(row)
                    continue
                time.sleep(0.05)
            if len(got) < self._shard_factor:
                ok = False
                break
        if ok:
            # the window's published copy: the shard it is rotated to
            for nm in self._win_names:
                win = _windows._get_window(nm)
                cur = self._rejoin_shards[(nm, rank)].get(
                    max(win.active_shard, 0))
                if cur is not None and rank in win.owned:
                    win.install_row(rank, cur)
        return ok

    def _realign_rotation(self) -> None:
        """Re-derive the rotation from the adopted step counter
        (``_comm_rounds == _counter // k`` on every stepping controller),
        or the wire's shard guard discards this rank's deposits forever."""
        self._comm_rounds = self._counter // self.num_steps_per_communication

    def _rejoin_state_transfer(self) -> None:
        win0 = _windows._get_window(self._win_names[0])
        owned = sorted(win0.owned)
        deadline = time.monotonic() + float(
            knob_env("BFT_CP_QUARANTINE_TIMEOUT"))
        donors: Dict[int, int] = {}
        for r in owned:
            for d in self._donor_candidates(win0, r):
                if self._transfer_rank(r, d, deadline):
                    donors[r] = d
                    break
            if r not in donors:
                break
        if len(donors) == len(owned):
            try:
                cl = _cp.client()
                # one rank per controller: a donor's controller is its rank
                steps = [int(cl.get(self._step_counter_key(p)))
                         for p in set(donors.values())]
                if steps:
                    self._counter = max(self._counter, max(steps))
            except (OSError, RuntimeError):
                pass
            self._realign_rotation()
            logger.warning(
                "rejoin: window state transferred from live in-neighbors "
                "%s (step counter -> %d)", donors, self._counter)
            self._adopt_window_rows()
            return
        step = self._restore_from_checkpoint()
        if step is not None:
            self._counter = int(step)
            self._realign_rotation()
            logger.warning(
                "rejoin: no live in-neighbor served state transfer; "
                "restored the newest local checkpoint (step %d)", step)
            return
        logger.error(
            "rejoin: no live donor and no checkpoint "
            "(BFT_CHECKPOINT_DIR unset/empty) — continuing from FRESH "
            "parameters; this rank re-enters averaging with "
            "initialization-time values")

    def _adopt_window_rows(self) -> None:
        """The parameters from the windows' rows (host-side: a one-sided
        rejoin runs no collective), in place."""
        params = self._params
        with torch.no_grad():
            for nm, idxs, spec in zip(self._win_names, self._groups,
                                      self._specs):
                win = _windows._get_window(nm)
                me = win.owned[0]
                if self._shard_factor > 1:
                    got = self._rejoin_shards.get((nm, me), {})
                    rows = _fusion.assemble_rows(
                        [got[s] for s in range(self._shard_factor)], spec)
                else:
                    rows = _fusion.unpack_row(
                        self._window_row_to_params(win, me), spec)
                for i, row in zip(idxs, rows):
                    params[i].copy_(_fusion.from_host(
                        row, params[i].dtype, params[i].device))

    def _window_row_to_params(self, win, rank: int) -> np.ndarray:
        """Window row -> parameter row (identity; push-sum de-biases)."""
        return win._rows[rank]

    def _restore_from_checkpoint(self) -> Optional[int]:
        """This rank's state from the newest checkpoint under
        ``BFT_CHECKPOINT_DIR``, read by this rank alone; the step, or None."""
        ckdir = knob_env("BFT_CHECKPOINT_DIR")
        if not ckdir or not os.path.isdir(ckdir):
            return None
        from . import checkpoint as _ckpt

        path = _ckpt.latest_path(ckdir)
        if path is None:
            return None
        try:
            _, step = _ckpt.restore(path, self, collective=False)
        except Exception as exc:  # noqa: BLE001 — fall through to fresh
            logger.error("rejoin: checkpoint restore from %s failed (%s)",
                         path, exc)
            return None
        self._reseed_windows()
        return step

    def _reseed_windows(self) -> None:
        """Re-publish the owned rows from the restored parameters (a
        sharded window: the shard it is rotated to)."""
        params = self._params
        for nm, idxs, spec in zip(self._win_names, self._groups,
                                  self._specs):
            win = _windows._get_window(nm)
            shard = max(win.active_shard, 0) if self._shard_factor > 1 \
                else None
            rows = [_fusion.to_host(params[i]) for i in idxs]
            for r in win.owned:
                win.install_row(r, _fusion.pack_row(rows, spec, shard=shard))


class DistributedWinPutOptimizer(_WindowOptimizer):
    """Push-style gossip: put the parameters into the out-neighbours'
    mailboxes, then combine self and the received values (reference
    optimizers.py:867, pull_style=False; JAX :1400)."""

    def __init__(self, *args, **kw) -> None:
        self.dst_weights = None
        self.self_weight = None
        self.neighbor_weights = None
        super().__init__(*args, **kw)

    def _gossip(self, packed):
        # the failure detector, every step: dead neighbours drop out of the
        # send and combine tables and the weights renormalize over the live
        # sets; the tables are rebuilt only when the dead set changes
        dead = self._dead_ranks()
        demoted = _tuner.demoted_edges()
        dst_weights, self_weight = self.dst_weights, self.self_weight
        neighbor_weights = self.neighbor_weights
        if dead or demoted:
            win = _windows._get_window(self._win_names[0])
            custom = (dst_weights is not None or self_weight is not None
                      or neighbor_weights is not None)
            key = ("put", frozenset(dead), demoted)
            cached = None if custom else self._healed_cache.get(key)
            if cached is None:
                if dead:
                    _metrics.counter("opt.healed_rebuilds").inc()
                sw, nw = _healed_recv_weights(win, dead, self_weight,
                                              neighbor_weights, demoted)
                cached = (_healed_send_table(win, dead, dst_weights,
                                             demoted), sw, nw)
                if not custom:
                    if len(self._healed_cache) > 16:
                        self._healed_cache.clear()
                    self._healed_cache[key] = cached
            dst_weights, self_weight, neighbor_weights = cached
        out = []
        for nm, row in zip(self._win_names, packed):
            mutex = self._mutex_ok(_windows._get_window(nm))
            _windows.win_put(row, nm, dst_weights=dst_weights,
                             require_mutex=mutex)
            out.append(_windows.win_update(
                nm, self_weight=self_weight,
                neighbor_weights=neighbor_weights, require_mutex=mutex))
        return out


class DistributedPullGetOptimizer(_WindowOptimizer):
    """Pull-style gossip: publish the parameters, pull the in-neighbours'
    current rows, combine (reference optimizers.py:821, pull_style=True;
    JAX :1514)."""

    def __init__(self, *args, **kw) -> None:
        self.src_weights = None
        self.self_weight = None
        self.neighbor_weights = None
        super().__init__(*args, **kw)

    def _gossip_peers(self, win, owned, dead=frozenset()):
        # a get locks the SOURCE ranks it reads
        return {s for d in owned for s in win.in_neighbors[d]
                if s not in dead}

    def _gossip(self, packed):
        dead = self._dead_ranks()
        demoted = _tuner.demoted_edges()
        src_weights, self_weight = self.src_weights, self.self_weight
        neighbor_weights = self.neighbor_weights
        if dead or demoted:
            win = _windows._get_window(self._win_names[0])
            custom = (src_weights is not None or self_weight is not None
                      or neighbor_weights is not None)
            key = ("get", frozenset(dead), demoted)
            cached = None if custom else self._healed_cache.get(key)
            if cached is None:
                if dead:
                    _metrics.counter("opt.healed_rebuilds").inc()
                # pull only from LIVE sources and renormalize the combine
                _, live_in = _live_neighbor_sets(win, dead, demoted)
                if src_weights is None:
                    srcw = {r: {s: 1.0 for s in live_in[r]}
                            for r in range(win.size)}
                else:
                    table = _windows._edge_weights(
                        src_weights, win.in_neighbors, 1.0, "src_weights",
                        win.size)
                    srcw = {r: {s: w for s, w in table[r].items()
                                if s not in dead and (s, r) not in demoted}
                            for r in range(win.size)}
                sw, nw = _healed_recv_weights(win, dead, self_weight,
                                              neighbor_weights, demoted)
                cached = (srcw, sw, nw)
                if not custom:
                    if len(self._healed_cache) > 16:
                        self._healed_cache.clear()
                    self._healed_cache[key] = cached
            src_weights, self_weight, neighbor_weights = cached
        out = []
        for nm, row in zip(self._win_names, packed):
            win = _windows._get_window(nm)
            mutex = self._mutex_ok(win)
            win.self_value = row  # publish
            _windows.win_get(nm, src_weights=src_weights,
                             require_mutex=mutex)
            out.append(_windows.win_update(
                nm, self_weight=self_weight,
                neighbor_weights=neighbor_weights, require_mutex=mutex))
        return out


class DistributedPushSumOptimizer(_WindowOptimizer):
    """Push-sum gossip with the associated weight p (column-stochastic
    sends; reference optimizers.py:624-773, JAX :1641).

    Each rank's window holds the numerator ``x * p`` (p, an f64 on the
    host, cast to the window dtype for the product); the p scalar rides
    the window's associated-p channel; the parameters are numerator / p.
    The constructor turns the associated-p flag on and :meth:`free` puts
    it back. Gauges: ``pushsum.minted`` (the p this controller created),
    ``pushsum.mass`` (its p now) and ``pushsum.debias_drift``
    (``max|p - 1|``); ``sum(mass) == sum(minted)`` over the job holds
    exactly through a rejoin's mass split.
    """

    _zero_init = True  # no stale mass in the mailboxes
    _consensus_gauge = False

    def __init__(self, *args, **kw) -> None:
        st = _global_state()
        self._prior_associated_p = st.win_ops_with_associated_p
        self._reminted = False
        was_rejoining = _hb.quarantine_pending()
        _windows.turn_on_win_ops_with_associated_p()
        try:
            super().__init__(*args, **kw)
        except BaseException:
            self._restore_flags()
            raise
        minted = mass = 0.0
        for nm in self._win_names:
            win = _windows._get_window(nm)
            if not was_rejoining or self._reminted:
                minted += float(len(win.owned))
            mass += sum(win.host.read_p_owned().values())
        _metrics.gauge("pushsum.minted").set(minted)
        _metrics.gauge("pushsum.mass").set(mass)

    def _restore_flags(self) -> None:
        _global_state().win_ops_with_associated_p = self._prior_associated_p

    def _gossip(self, packed):
        st = _global_state()
        n = st.size
        # every rank splits its mass 1/(outdeg+1) over itself and each
        # out-neighbour; dead destinations and demoted edges drop from the
        # send side, so the columns stay stochastic over the live set and
        # the mass is conserved by construction
        dead = self._dead_ranks()
        demoted = _tuner.demoted_edges()
        key = (frozenset(dead), demoted)
        cached = self._healed_cache.get(key)
        if cached is None:
            if dead:
                _metrics.counter("opt.healed_rebuilds").inc()
            out_nbrs = {
                r: [d for d in
                    topology_util.out_neighbor_ranks(st.topology, r)
                    if d not in dead and (r, d) not in demoted]
                for r in range(n)}
            sw = {r: 1.0 / (len(out_nbrs[r]) + 1) for r in range(n)}
            dw = {r: {dst: sw[r] for dst in out_nbrs[r]} for r in range(n)}
            if len(self._healed_cache) > 16:
                self._healed_cache.clear()
            self._healed_cache[key] = cached = (sw, dw)
        sw, dw = cached
        out = []
        mass = drift = 0.0
        for nm, row in zip(self._win_names, packed):
            win = _windows._get_window(nm)
            me = win.rank
            mutex = self._mutex_ok(win)
            p = win.host.read_p_owned()[me]
            # numerator = x * p, p cast to the window dtype first; a host
            # 0-dim tensor rides the kernel's arguments (a device one would
            # copy, and so wait for the step's queued work)
            numer = row * torch.tensor(p, dtype=row.dtype)
            _windows.win_accumulate(numer, nm, self_weight=sw,
                                    dst_weights=dw, require_mutex=mutex)
            collected = _windows.win_update_then_collect(
                nm, require_mutex=mutex)
            p_new = win.host.read_p_owned()[me]
            mass += p_new
            drift = max(drift, abs(p_new - 1.0))
            out.append(collected / torch.tensor(p_new,
                                                dtype=collected.dtype))
        _metrics.gauge("pushsum.mass").set(mass)
        _metrics.gauge("pushsum.debias_drift").set(drift)
        return out

    # -- the rejoin with exact mass conservation ------------------------------
    #
    # A copy would duplicate the donor's mass and a fresh p = 1 would mint
    # some; the rejoiner asks for a SPLIT instead. At its next step's serve
    # scan (gated on the epoch the request bumps) the donor halves its
    # numerator row and p under the rank mutex (exact: an exponent
    # decrement), republishes, and parks the other half under transfer
    # keys the rejoiner installs.

    def _window_row_to_params(self, win, rank: int) -> np.ndarray:
        p = win.host.read_p_owned()[rank]
        row = win._rows[rank]
        if p <= 0:
            return row
        return _codec.cast(_codec.cast(row, np.float64) / p, row.dtype)

    def _transfer_rank(self, rank: int, donor: int, deadline: float) -> bool:
        if self._shard_factor > 1:
            # a sharded row is the active shard's numerator only: halving
            # it with p would de-bias the other shards' implicit numerators;
            # the checkpoint re-mint is the sharded path
            return False
        cl = _cp.client()
        for nm in self._win_names:
            cl.put(f"w.{nm}.msreq.{rank}", donor + 1)
        # poke the donors' serve scans (they run on an epoch change)
        _cp.bump_membership_epoch()
        done_keys = [f"w.{nm}.msdone.{rank}" for nm in self._win_names]
        # a bounded wait per donor, leaving budget for the other candidates
        wait_until = min(deadline, time.monotonic() + max(
            5.0, (deadline - time.monotonic()) / 2.0))
        served = False
        while time.monotonic() < wait_until:
            try:
                if all(cl.get(k) for k in done_keys):
                    served = True
                    break
            except OSError:
                break
            time.sleep(0.05)
        if not served:
            for nm in self._win_names:  # withdraw; try the next donor
                cl.put(f"w.{nm}.msreq.{rank}", 0)
            return False
        for nm in self._win_names:
            win = _windows._get_window(nm)
            ht = _fusion.host_dtype(win.dtype)
            raw = cl.get_bytes(f"w.{nm}.xfer.{rank}")
            expect = int(np.prod(win.row_shape, dtype=np.int64)) * \
                ht.itemsize
            if len(raw) != expect:
                return False
            win.install_row(rank, np.frombuffer(raw, ht).reshape(
                win.row_shape))
            win.host.write_p_entries(
                {rank: _cp.get_float(cl, f"w.{nm}.xferp.{rank}")})
            cl.put(f"w.{nm}.msdone.{rank}", 0)
            cl.put_bytes(f"w.{nm}.xfer.{rank}", b"")
        return True

    def _serve_rejoin_requests(self) -> None:
        ep = _hb.membership_epoch()
        if ep == self._serve_epoch:
            return
        self._serve_epoch = ep
        cl = _cp.client()
        for nm in self._win_names:
            win = _windows._get_window(nm)
            try:
                reqs = cl.get_many(
                    [f"w.{nm}.msreq.{r}" for r in range(win.size)])
            except (OSError, RuntimeError):
                return
            for r, req in enumerate(reqs):
                d = int(req) - 1
                if req <= 0 or d not in win.owned:
                    continue
                with _windows.win_mutex(nm, ranks=[d]), win.state_mu:
                    half = _halve(win._rows[d])
                    p_half = win.host.read_p_owned()[d] * 0.5
                    win._rows[d] = half
                    win.host.write_p_entries({d: p_half})
                    win._publish_selves([d])
                    cl.put_bytes(f"w.{nm}.xfer.{r}",
                                 np.ascontiguousarray(half).tobytes())
                    _cp.put_float(cl, f"w.{nm}.xferp.{r}", p_half)
                cl.put(f"w.{nm}.msreq.{r}", 0)
                cl.put(f"w.{nm}.msdone.{r}", 1)
                logger.warning(
                    "rejoin: split push-sum mass of owned rank %d with "
                    "rejoining rank %d (window %s, p -> %g each)",
                    d, r, nm, p_half)

    def _reseed_windows(self) -> None:
        super()._reseed_windows()
        self._reminted = True
        # the old incarnation's mass died with it and no donor split: the
        # checkpoint fallback re-mints p = 1 for this controller's ranks
        logger.warning(
            "rejoin: push-sum restored from checkpoint re-mints p=1 for "
            "its ranks — total mass is NOT conserved on this path (no "
            "live donor to split with)")
        for nm in self._win_names:
            win = _windows._get_window(nm)
            win.host.write_p_entries({r: 1.0 for r in win.owned})
