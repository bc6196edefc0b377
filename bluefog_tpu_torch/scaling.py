"""Scaling evidence: the real train steps' collectives under a fake world.

Counterpart of ``bluefog_tpu/scaling.py``. The JAX package lowers its
production step programs for abstract meshes of 8-128 devices and counts
the collectives in the StableHLO. The port has no program text to read: it
issues its collectives eagerly, one process per rank. So it RUNS the
production step as rank r of a world of n in one process, over torch's
``fake`` process-group backend (every collective returns at once and moves
nothing), and records each ``c10d`` op the step dispatches with a
``TorchDispatchMode``: its class, the bytes handed to it and the size of
its group. That dispatch record is the port's counterpart of the lowered
module. What it shows (``tests/test_torch_port_scaling.py`` holds it to
JAX's counts):

  * static Expo-2 neighbor step: ``ceil(log2 n)`` P2P rounds, no
    all-reduce; dynamic one-peer: ONE round; each round hands one copy of
    the parameters to the wire;
  * hierarchical: one all-reduce over a group of ``local_size`` ranks, and
    rounds over the machine group only;
  * ZeRO-1: one reduce-scatter and one all-gather, no all-reduce;
  * the flash ring's forward: two sends per ring step (the K and V block
    hops), each one ``[B, S/n, H, D]`` block;
  * the expert-parallel MoE LM's gradient: four all-to-alls per MoE layer
    at every n, with a per-chip payload that stays flat.

The port packs a step's parameters into one flat buffer (``optimizers.py``
``fused_combine``), so a round carries every leaf at once: its round count
does not grow with the leaves, where JAX's StableHLO holds one permute per
leaf (XLA's combiner merges them downstream). ``python -m
bluefog_tpu_torch.scaling`` writes ``SCALING_TORCH.md`` (``--device cpu``
without a card); the text names no device, so both runs write one file.

The received and gathered buffers of a fake world hold whatever the
allocator left there, so the values a recorded step computes mean nothing:
only the record, and the compute the step launched, are real.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from . import optimizers as _opts
from . import topology as topology_util
from .models import MoETransformerLM
from .ops.neighbors import _uniform_weights
from .ops.plan import CombinePlan
from .parallel.context import ring_attention_shard
from .parallel.expert import ep_lm_loss_fn
from .runtime.state import init, resolve_device, shutdown, size

_COLLECTIVES = (
    "collective_permute", "all_reduce", "all_gather", "reduce_scatter",
    "all_to_all",
)

# each c10d op under the class of JAX's StableHLO op it stands for; a P2P
# round is one ``send`` (its ``recv_`` is the same round's other half)
_OP_CLASS = {
    "send": "collective_permute", "recv_": "recv",
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_coalesced_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "alltoall_": "all_to_all", "alltoall_base_": "all_to_all",
}
# the schema arguments that carry the tensors an op is handed
_INPUT_ARGS = ("tensors", "input_tensors", "input_tensor", "input", "inputs")


# ---------------------------------------------------------------------------
# Plans (the optimizers' default plans, as JAX's scaling module builds them)
# ---------------------------------------------------------------------------

def uniform_weight_matrix(topo) -> np.ndarray:
    """Uniform 1/(indegree+1) combine matrix: the optimizer default when no
    user weights are given."""
    return _uniform_weights(topo, topo.number_of_nodes())


def static_expo2_plan(n: int) -> CombinePlan:
    return CombinePlan(uniform_weight_matrix(
        topology_util.ExponentialTwoGraph(n)))


def _onepeer_sends(n: int, step: int) -> Dict[int, List[int]]:
    topo = topology_util.ExponentialTwoGraph(n)
    send = {}
    for r in range(n):
        it = topology_util.GetDynamicSendRecvRanks(topo, r)
        for _ in range(step + 1):
            send_ranks, _ = next(it)
        send[r] = send_ranks
    return send


def dynamic_onepeer_plan(n: int, step: int = 0) -> CombinePlan:
    """The one-peer Expo-2 schedule's step-``step`` combine matrix: every
    rank sends to exactly one peer (reference topology_util.py:315-357)."""
    return CombinePlan(topology_util.dynamic_weight_matrix(
        n, _onepeer_sends(n, step)))


def dynamic_onepeer_args(n: int, step: int = 0) -> Tuple[dict, dict, dict]:
    """``(send_neighbors, self_weight, neighbor_weights)`` of that step in
    the global form the neighbor optimizer takes: the arguments from which
    it builds :func:`dynamic_onepeer_plan`'s matrix."""
    send = _onepeer_sends(n, step)
    W = topology_util.dynamic_weight_matrix(n, send)
    recv = {dst: {} for dst in range(n)}
    for src, dsts in send.items():
        for dst in dsts:
            recv[dst][src] = float(W[src, dst])
    return send, {r: float(W[r, r]) for r in range(n)}, recv


# ---------------------------------------------------------------------------
# The fake world and the dispatch record
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n: int, rank: int = 0, device=None,
               local_size: Optional[int] = None):
    """This process as rank ``rank`` of a world of ``n`` over torch's
    ``fake`` backend, with the runtime initialised on ``device`` (the card
    unless ``"cpu"``); both are shut down on exit. No control plane
    attaches: a fake world has no peers to serve."""
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process with no process "
                           "group; shut the current one down first")
    # registers the "fake" backend for the CPU and CUDA devices
    from torch.testing._internal.distributed.fake_pg import FakeStore

    with mock.patch.dict(os.environ, {"BFT_CP_DISABLE": "1"}):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=n)
        try:
            init(device=dev, local_size=local_size)
            yield
        finally:
            shutdown()
            dist.destroy_process_group()


class Collective(NamedTuple):
    """One ``c10d`` op a recorded run dispatched."""

    op: str            # the c10d op, e.g. "allreduce_"
    cls: str           # JAX's class of it, "recv", or "other"
    bytes_in: int      # bytes of the tensors handed to it
    group_size: int
    negotiate: bool    # issued by a shape check (``all_gather_object``)
    device: str        # the device type of the tensors handed to it


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _in_all_gather_object() -> bool:
    """True inside ``torch.distributed.all_gather_object``: the port's
    negotiate stage and its shard checks gather shapes through it."""
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        if code.co_name == "all_gather_object" and \
                code.co_filename.endswith("distributed_c10d.py"):
            return True
        f = f.f_back
    return False


class record_collectives(TorchDispatchMode):
    """Record every ``c10d`` op dispatched inside the ``with`` block into
    ``self.ops`` (a list of :class:`Collective`), then run it."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            name = func._schema.name.split("::")[-1]
            bound = dict(zip((a.name for a in func._schema.arguments), args))
            bound.update(kwargs)
            pg = bound.get("process_group")
            size = dist.ProcessGroup.unbox(pg).size() if pg is not None \
                else 0
            ts = [t for a in _INPUT_ARGS for t in _tensors(bound.get(a))]
            self.ops.append(Collective(
                name, _OP_CLASS.get(name, "other"),
                sum(t.numel() * t.element_size() for t in ts), size,
                _in_all_gather_object(),
                ts[0].device.type if ts else "none"))
        return func(*args, **kwargs)


def collective_counts(record: List[Collective]) -> Dict[str, int]:
    """Ops of each of JAX's collective classes in ``record``, and under
    ``negotiate`` the ops of the shape checks (which JAX's programs lack:
    their shapes are static)."""
    out = {name: 0 for name in _COLLECTIVES + ("negotiate",)}
    for c in record:
        if c.negotiate:
            out["negotiate"] += 1
        elif c.cls in out:
            out[c.cls] += 1
    return out


def collective_bytes(record: List[Collective]) -> Dict[str, int]:
    """Bytes handed to each of JAX's collective classes in ``record``: what
    this rank gives the interconnect (a round's ``send``, not its receive
    buffer; the shape checks left out)."""
    out = {name: 0 for name in _COLLECTIVES}
    for c in record:
        if not c.negotiate and c.cls in out:
            out[c.cls] += c.bytes_in
    return out


# ---------------------------------------------------------------------------
# The recorded steps
# ---------------------------------------------------------------------------

KINDS = (
    "allreduce", "gradient_allreduce", "neighbor_static_expo2",
    "neighbor_dynamic_onepeer", "hierarchical", "zero1",
)


def train_step_optimizer(kind: str, optimizer: torch.optim.Optimizer,
                         model: nn.Module, loss_fn, *, step: int = 0):
    """The port's production optimizer for one of :data:`KINDS` around
    ``optimizer``. The neighbor kinds run on the runtime's topology
    (``init``'s Expo-2: the static plan) or, for the one-peer kind, on the
    one-peer schedule's step ``step`` through the optimizer's dynamic
    arguments. Needs ``init`` first."""
    cls = {
        "allreduce": _opts.DistributedAllreduceOptimizer,
        "gradient_allreduce": _opts.DistributedGradientAllreduceOptimizer,
        "neighbor_static_expo2": _opts.DistributedNeighborAllreduceOptimizer,
        "neighbor_dynamic_onepeer":
            _opts.DistributedNeighborAllreduceOptimizer,
        "hierarchical":
            _opts.DistributedHierarchicalNeighborAllreduceOptimizer,
        "zero1": _opts.DistributedShardedAllreduceOptimizer,
    }.get(kind)
    if cls is None:
        raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")
    opt = cls(optimizer, model, loss_fn)
    if kind == "neighbor_dynamic_onepeer":
        (opt.send_neighbors, opt.self_weight,
         opt.neighbor_weights) = dynamic_onepeer_args(size(), step)
    return opt


class _Chain(nn.Module):
    """JAX ``lower_train_step``'s model: ``n_leaves`` ``[d, d]`` matrices,
    ``h = tanh(h @ w)`` through each."""

    def __init__(self, d: int, n_leaves: int, device) -> None:
        super().__init__()
        self.w = nn.ParameterList(
            nn.Parameter(torch.zeros((d, d), device=device))
            for _ in range(n_leaves))

    def forward(self, h):
        for w in self.w:
            h = torch.tanh(h @ w)
        return h


def _chain_loss(model, batch):
    x, y = batch
    return ((model(x) - y) ** 2).mean()


def record_train_step(kind: str, n: int, *, rank: int = 0,
                      local_size: int = 4, d: int = 64, batch: int = 8,
                      n_leaves: int = 1, device=None) -> List[Collective]:
    """Record one production train step of ``kind`` as rank ``rank`` of a
    fake world of ``n`` (JAX ``lower_train_step``): SGD 0.1 on JAX's model
    of ``n_leaves`` ``[d, d]`` leaves. The hierarchical kind runs
    ``local_size`` ranks a machine, which must divide ``n``."""
    if kind == "hierarchical" and n % local_size:
        raise ValueError("local_size must divide n for hierarchical")
    dev = resolve_device(device)
    with fake_world(n, rank, dev, local_size if kind == "hierarchical"
                    else n):
        model = _Chain(d, n_leaves, dev)
        opt = train_step_optimizer(
            kind, torch.optim.SGD(model.parameters(), lr=0.1), model,
            _chain_loss)
        data = (torch.zeros((batch, d), device=dev),
                torch.zeros((batch, d), device=dev))
        with record_collectives() as rec:
            opt.step(data)
    return rec.ops


def record_cp_forward(n: int, *, rank: int = 0, seq: int = 1024,
                      heads: int = 8, d_head: int = 64, batch: int = 1,
                      causal: bool = True, device=None
                      ) -> Tuple[List[Collective], int]:
    """Record the flash ring's forward (``ring_attention_shard`` with
    ``use_flash=True``: K1 at each ring step on the card) as rank ``rank``
    of a fake ring of ``n`` over a ``[batch, seq, heads, d_head]`` bf16
    sequence (JAX ``lower_cp_forward``). Returns the record and the ring
    steps that rotated K/V (``n - 1``: the last block is not sent on)."""
    dev = resolve_device(device)
    with fake_world(n, rank, dev):
        q = torch.zeros((batch, seq // n, heads, d_head),
                        dtype=torch.bfloat16, device=dev)
        with torch.no_grad(), record_collectives() as rec:
            ring_attention_shard(q, q, q, causal=causal, use_flash=True)
    return rec.ops, n - 1


def record_moe_lm_grad(n: int, *, rank: int = 0, n_layers: int = 2,
                       moe_every: int = 2, seq: int = 256, d_model: int = 16,
                       d_ff: int = 32, vocab: int = 32, num_heads: int = 2,
                       dtype=torch.float32, attn_fn=None, device=None
                       ) -> List[Collective]:
    """Record the expert-parallel MoE LM's loss and its gradient
    (``ep_lm_loss_fn``, then ``backward``) as rank ``rank`` of a fake world
    of ``n`` experts, one per rank, on ``seq`` local tokens (JAX
    ``lower_moe_lm_grad``). ``attn_fn`` is the model's attention (default:
    ``TransformerLM``'s dense one; ``flash_attention`` runs K1-K3)."""
    dev = resolve_device(device)
    with fake_world(n, rank, dev):
        model = MoETransformerLM(
            vocab_size=vocab, num_experts=n, num_layers=n_layers,
            num_heads=num_heads, d_model=d_model, d_ff=d_ff,
            moe_every=moe_every, expert_axis="expert", dtype=dtype,
            attn_fn=attn_fn, device=dev)
        toks = torch.zeros((1, seq), dtype=torch.long, device=dev)
        loss_fn = ep_lm_loss_fn(model)
        with record_collectives() as rec:
            loss_fn(model, (toks, toks)).backward()
    return rec.ops


# ---------------------------------------------------------------------------
# Wire-bytes model
# ---------------------------------------------------------------------------

def wire_bytes_per_chip(kind: str, n: int, param_bytes: float,
                        local_size: int = 4) -> Tuple[float, int]:
    """(bytes sent per chip per step, serial collective rounds).

    P = param_bytes. Ring allreduce sends 2P(n-1)/n in 2(n-1) rounds;
    a P2P round sends P in one round; ZeRO-1 is reduce_scatter + all_gather =
    allreduce volume split into 2(n-1) one-shard rounds. Hierarchical's
    figure is the combined intra-machine (2P(l-1)/l) plus machine-group
    (ceil(log2 m) * P, the only part that leaves the machine) traffic.
    """
    P_ = param_bytes
    if kind in ("allreduce", "gradient_allreduce", "zero1"):
        return 2 * P_ * (n - 1) / n, 2 * (n - 1)
    if kind == "neighbor_static_expo2":
        k = max(1, math.ceil(math.log2(n)))
        return k * P_, k
    if kind == "neighbor_dynamic_onepeer":
        return P_, 1
    if kind == "hierarchical":
        m = n // local_size
        k = max(0, math.ceil(math.log2(m))) if m > 1 else 0
        local = 2 * P_ * (local_size - 1) / local_size
        return local + k * P_, 2 * (local_size - 1) + k
    raise ValueError(kind)


# ResNet-50's parameter footprint, the reference benchmark model
RESNET50_BYTES = 25_557_032 * 4
# the rank the table is recorded at (any rank gives the same counts)
RECORD_RANK = 5


def evidence(ns=(8, 16, 64, 128), local_size: int = 4, device=None):
    """Counts + dispatched bytes + analytic byte model per strategy/size."""
    rows = []
    for n in ns:
        for kind in KINDS:
            rec = record_train_step(kind, n, rank=RECORD_RANK,
                                    local_size=local_size, device=device)
            bytes_, rounds = wire_bytes_per_chip(
                kind, n, RESNET50_BYTES, local_size)
            rows.append({
                "kind": kind, "n": n, "counts": collective_counts(rec),
                "kb_in": sum(collective_bytes(rec).values()) / 1e3,
                "mb_per_chip_step": bytes_ / 1e6, "rounds": rounds,
            })
    return rows


def write_scaling_md(path: str = "SCALING_TORCH.md", ns=(8, 16, 64, 128),
                     device=None) -> None:
    rows = evidence(ns, device=device)
    ar = {r["n"]: r["mb_per_chip_step"] for r in rows
          if r["kind"] == "allreduce"}
    lines = [
        "# Scaling evidence of the PyTorch port",
        "",
        "Generated by `python -m bluefog_tpu_torch.scaling`; locked by"
        " `tests/test_torch_port_scaling.py`. The JAX package's table is"
        " `SCALING.md`.",
        "",
        "The production train steps (`optimizers.py`'s fused, hierarchical"
        " and ZeRO-1 optimizers) run as one rank of a fake world of 8-128"
        " ranks (torch's `fake` process-group backend: every collective"
        " returns at once and moves nothing), and a `TorchDispatchMode`"
        " records each `c10d` op the step dispatches: its class, the bytes"
        " handed to it and the size of its group. Recorded at rank"
        f" {RECORD_RANK}; every rank gives the same counts. The byte model"
        " follows from the counts (one P2P round = one parameter-size"
        " transmit per chip; ring allreduce = 2P(n-1)/n). Parameter volume:"
        f" ResNet-50 ({RESNET50_BYTES / 1e6:.1f} MB f32), the reference"
        " benchmark model.",
        "",
        "| strategy | n | permute | all_reduce | all_gather | reduce_scatter"
        " | negotiate | dispatched KB in | MB/chip/step | serial rounds"
        " | vs allreduce |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        c = r["counts"]
        rel = r["mb_per_chip_step"] / ar[r["n"]]
        lines.append(
            f"| {r['kind']} | {r['n']} | {c['collective_permute']} |"
            f" {c['all_reduce']} | {c['all_gather']} | {c['reduce_scatter']}"
            f" | {c['negotiate']} | {r['kb_in']:.1f} |"
            f" {r['mb_per_chip_step']:.1f} | {r['rounds']} | {rel:.2f}x |")
    lines += [
        "",
        "Reading the table:",
        "",
        "- **permute** counts P2P rounds: one `send` per shift (the round's"
        " receive is its other half). **dispatched KB in** sums the bytes"
        " each rank hands to its collectives per step (the model is one"
        " 64x64 f32 leaf = 16.4 KB; the MB column scales that structure to"
        " ResNet-50's 102 MB). It equals `SCALING.md`'s HLO KB in on every"
        " row.",
        "- **negotiate** counts the shape checks' gathers"
        " (`all_gather_object`), which JAX's programs lack: their shapes"
        " are static. The optimizer steps issue none.",
        "- **Dynamic one-peer Expo-2** moves ONE parameter copy per chip per"
        " step in ONE round at every size; **static Expo-2** pays"
        " ceil(log2 n) rounds and no all-reduce; **hierarchical** keeps its"
        " all-reduce on a group of `local_size` ranks and crosses machines"
        " only in rounds over the machine group; **ZeRO-1** is one"
        " reduce-scatter and one all-gather, with 1/n of the optimizer"
        " state per chip.",
        "",
        "Counts are per step, not per leaf: the port packs every parameter"
        " into one flat buffer (`optimizers.fused_combine`), so three leaves"
        " take the rounds of one with three times the bytes, where JAX's"
        " StableHLO holds one permute per leaf and shift.",
        "",
        "**Long-context axis** (`record_cp_forward`): the flash ring's"
        " forward sends two blocks per ring step (K and V, one hop each) and"
        " no all-reduce; each carries one [B, S/n, H, D] bf16 block, so the"
        " bytes per ring step shrink linearly with the ring.",
        "",
        "**Expert-parallel axis** (`record_moe_lm_grad`): the MoE LM's loss"
        " and gradient dispatch 4 all_to_all per MoE layer (2 forward, 2"
        " backward) at every size, and each chip's all_to_all payload stays"
        " flat as n grows. Beside them: the loss's all-reduces (the"
        " replicated parameters' gradient sum and the loss's global sum)"
        " and the batch check's gather (negotiate).",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.scaling",
        description="Record the production train steps' collectives under "
        "fake worlds of 8-128 ranks and write the table.")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default="SCALING_TORCH.md")
    args = ap.parse_args(argv)
    write_scaling_md(args.out, device=args.device)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
