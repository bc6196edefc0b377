"""One rank of the PyTorch port's world-N tests (gloo over a FileStore).

The parent test calls :func:`run_world`, which starts ``world`` copies of
this file as separate processes, one per rank:

    python _torch_port_child.py <mode> <rank> <world> <dir>

(``torchrun ... _torch_port_child.py examples <dir>`` instead runs the
port's examples in a ``torchrun`` world, :func:`_examples`.)

Each child joins the process group through ``<dir>/store``, reads its
inputs from ``<dir>/inputs.npz`` (made by the parent with numpy from a
seed), runs ``<mode>`` through the port, and writes ``<dir>/out_<rank>.npz``.
The children import the port only, never JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(mode: str, tmp_dir: str, world: int = 4,
              timeout: float = 300.0, killed=()):
    """Run ``mode`` on ``world`` child ranks; returns each rank's outputs.
    A rank in ``killed`` must end by SIGKILL; its outputs are None."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         tmp_dir], env=env, cwd=tmp_dir, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        want = -9 if r in killed else 0
        if p.returncode != want:
            raise RuntimeError(f"rank {r} of {mode} ended with "
                               f"{p.returncode}, not {want}:\n{logs[r]}")
    return [None if r in killed else
            dict(np.load(os.path.join(tmp_dir, f"out_{r}.npz")))
            for r in range(world)]


def _ops(bf, torch, rank: int, world: int, inp) -> dict:
    x = torch.from_numpy(inp["x"][rank])
    n = world
    out = {"static": bf.neighbor_allreduce(x)}
    nested = {r: {(r - 1) % n: 0.3, (r - 2) % n: 0.2} for r in range(n)}
    out["weighted"] = bf.neighbor_allreduce(
        x, self_weight=0.5, neighbor_weights=nested)
    out["dynamic"] = bf.neighbor_allreduce(
        x, self_weight=0.5,
        neighbor_weights={r: {(r - 1) % n: 0.5} for r in range(n)},
        send_neighbors={r: [(r + 1) % n] for r in range(n)})
    out["gather"] = bf.neighbor_allreduce(x, force_gather=True)
    out["bf16"] = bf.neighbor_allreduce(x.to(torch.bfloat16)).float()
    out["allreduce_avg"] = bf.allreduce(x)
    out["allreduce_sum"] = bf.allreduce(x, average=False)
    out["broadcast"] = bf.broadcast(x, root_rank=2)
    bf.set_topology(bf.topology_util.RingGraph(n), is_weighted=True)
    out["weighted_topo"] = bf.neighbor_allreduce(x)
    return {k: v.numpy() for k, v in out.items()}


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *mods, leaf = key.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = val
    return tree


def _flash_lm(bf, torch, inp):
    """The small flash ``TransformerLM`` of ``inp``'s config and flax
    weights (``p:<path>`` leaves)."""
    from bluefog_tpu_torch.parallel.flash import flash_attention
    from bluefog_tpu_torch.utils import params_from_jax

    cfg = {k: int(inp[k]) for k in ("vocab", "layers", "heads", "d_model",
                                    "d_ff")}
    model = bf.models.TransformerLM(
        vocab_size=cfg["vocab"], num_layers=cfg["layers"],
        num_heads=cfg["heads"], d_model=cfg["d_model"], d_ff=cfg["d_ff"],
        attn_fn=flash_attention, device="cpu")
    params = {k[len("p:"):]: v for k, v in inp.items() if k.startswith("p:")}
    model.load_state_dict(params_from_jax(_unflatten(params)))
    return model


def _slice(bf, torch, rank: int, world: int, inp) -> dict:
    model = _flash_lm(bf, torch, inp)
    opt = bf.DistributedNeighborAllreduceOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), model,
        bf.models.lm_loss)
    tokens = torch.from_numpy(inp["tokens"][rank]).long()
    targets = torch.from_numpy(inp["targets"][rank]).long()
    losses = [float(opt.step((tokens, targets))["loss"])
              for _ in range(int(inp["steps"]))]
    out = {f"sd:{k}": v.detach().numpy() for k, v in
           model.state_dict().items()}
    out["losses"] = np.asarray(losses)
    return out


def _optimizers(bf, torch, rank: int, world: int, inp) -> dict:
    """ZeRO-1 and the hierarchical optimizer on the cases of
    ``tests/test_optimizers.py``, both on the small flash LM, and
    ``broadcast_optimizer_state``."""
    from torch import nn

    class Leaves(nn.Module):
        def __init__(self, w, b):
            super().__init__()
            self.w = nn.Parameter(torch.as_tensor(w, dtype=torch.float32))
            self.b = nn.Parameter(torch.as_tensor(b, dtype=torch.float32))

    def multi_leaf_loss(model, t):
        return 0.5 * ((model.w - t) ** 2).sum() + \
            0.5 * ((model.b - 1.0) ** 2).sum()

    def state_sizes(opt):
        (shard,) = opt.base.param_groups[0]["params"]
        return np.array([v.numel() for v in opt.base.state[shard].values()
                         if v.dim() >= 1])

    out, flags = {}, {}
    # the two-leaf padding case (total 7, shard ceil(7 / n)) under ZeRO-1
    # and under the gradient allreduce it must match
    t = torch.full((4,), float(rank))
    for key, cls in (("zero1_ref", bf.DistributedGradientAllreduceOptimizer),
                     ("zero1", bf.DistributedShardedAllreduceOptimizer)):
        model = Leaves(np.zeros(4), np.full(3, 2.0))
        opt = cls(torch.optim.Adam(model.parameters(), lr=0.1), model,
                  multi_leaf_loss)
        out[f"{key}_losses"] = np.array([float(opt.step(t)["loss"])
                                         for _ in range(5)])
        out[f"{key}_w"], out[f"{key}_b"] = model.w, model.b
    out["zero1_state_sizes"] = state_sizes(opt)
    # total 13: the state holds ceil(13 / n) elements and the parameters
    # stay replicated after a step
    model = Leaves(np.zeros(10), np.zeros(3))
    opt = bf.DistributedShardedAllreduceOptimizer(
        torch.optim.Adam(model.parameters(), lr=0.1), model, multi_leaf_loss)
    opt.step(torch.full((10,), float(rank)))
    out["shard13_w"] = model.w
    out["shard13_state_sizes"] = state_sizes(opt)
    flags["zero1_local_steps"] = _raises(
        ValueError, lambda: bf.DistributedShardedAllreduceOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), model,
            multi_leaf_loss, num_steps_per_communication=2),
        "num_steps_per_communication")

    # hierarchical consensus: zero gradients, so one step is the combine
    model = Leaves(inp["x0"][rank], np.zeros(1))
    opt = bf.DistributedHierarchicalNeighborAllreduceOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), model,
        lambda m, b: 0.0 * m.w.sum())
    opt.step(None)
    out["hier_consensus"] = model.w

    # the small flash LM under both, 3 Adam steps from the flax weights
    tokens = torch.from_numpy(inp["tokens"][rank]).long()
    targets = torch.from_numpy(inp["targets"][rank]).long()
    for key, cls in (("lm_zero1", bf.DistributedShardedAllreduceOptimizer),
                     ("lm_hier",
                      bf.DistributedHierarchicalNeighborAllreduceOptimizer)):
        model = _flash_lm(bf, torch, inp)
        opt = cls(torch.optim.Adam(model.parameters(), lr=1e-3,
                                   eps=float(inp["adam_eps"])), model,
                  bf.models.lm_loss)
        out[f"{key}:losses"] = np.array(
            [float(opt.step((tokens, targets))["loss"])
             for _ in range(int(inp["steps"]))])
        out.update({f"{key}:sd:{k}": v for k, v in
                    model.state_dict().items()})

    # broadcast_optimizer_state from rank 1; rank 3 has not stepped yet
    p = nn.Parameter(torch.ones(3) * rank)
    adam = torch.optim.Adam([p], lr=0.1)
    if rank != 3:
        p.grad = (rank + 1.0) * torch.arange(3.0)
        adam.step()
    bf.broadcast_optimizer_state(adam, root_rank=1)
    state = adam.state[p]
    out["bos_exp_avg"] = state["exp_avg"]
    out["bos_exp_avg_sq"] = state["exp_avg_sq"]
    out["bos_step"] = state["step"]
    flags["bos_step_on_cpu"] = int(state["step"].device.type == "cpu")
    flags["bos_empty_root"] = _raises(
        ValueError, lambda: bf.broadcast_optimizer_state(
            torch.optim.Adam([nn.Parameter(torch.ones(2))]), root_rank=1),
        "empty on root")
    out = {k: v.detach().float().numpy() if torch.is_tensor(v) else v
           for k, v in out.items()}
    out.update({f"flag:{k}": np.array(v) for k, v in flags.items()})
    return out


def profiled_ranges(fn):
    """``fn()`` under ``torch.profiler`` started directly, as a recorder
    that keeps the host's ``record_function`` ranges alone (the user
    scope): no aten op, and ``torch.autograd.profiler``'s Python flag left
    unset. Returns ``(ranges, tid)``: each range's name to its sorted
    ``(start_ns, end_ns, thread)`` intervals, and the thread that ran
    ``fn``."""
    import torch
    from torch._C._autograd import _disable_profiler, _enable_profiler
    from torch._C._profiler import RecordScope

    prof = torch.autograd.profiler.profile(use_kineto=True)
    prof._prepare_trace()
    try:
        config = prof.config(create_trace_id=False)
    except TypeError:
        config = prof.config()
    _enable_profiler(config, prof.kineto_activities, {RecordScope.USER_SCOPE})
    try:
        with torch.profiler.record_function("test.window"):
            fn()
    finally:
        events = _disable_profiler().events()
    ranges: dict = {}
    for e in events:
        if e.is_user_annotation():
            start = e.start_ns()
            ranges.setdefault(e.name(), []).append(
                (start, start + e.duration_ns(), e.device_resource_id()))
    ranges = {k: sorted(v) for k, v in ranges.items()}
    return ranges, ranges["test.window"][0][2]


# the fused kinds of the step-span tests, by class name
SPAN_KINDS = ("DistributedGradientAllreduceOptimizer",
              "DistributedAllreduceOptimizer",
              "DistributedNeighborAllreduceOptimizer",
              "DistributedHierarchicalNeighborAllreduceOptimizer",
              "DistributedShardedAllreduceOptimizer")


def _step_spans(bf, torch, rank: int, world: int, inp) -> dict:
    """For each fused kind: one step (after a first) under a profiler
    started directly (:func:`profiled_ranges`), its spans' names, starts
    and ends on the step's thread; then the ``opt.combine_bytes``,
    ``opt.combine_sends`` and ``opt.plan_builds`` one untraced step added,
    beside the flat buffer's bytes and the plan's shifts, and the fullest
    ``step_report()`` of it and four more."""
    from torch import nn

    from bluefog_tpu_torch.runtime import metrics

    x = torch.from_numpy(inp["x"][rank])
    counters = ("opt.combine_bytes", "opt.combine_sends", "opt.plan_builds")
    out = {}
    for kind in SPAN_KINDS:
        torch.manual_seed(0)
        # a step of milliseconds, so the few the host spends between the
        # spans stay small beside it
        model = nn.Sequential(nn.Linear(x.shape[-1], 1024), nn.Tanh(),
                              nn.Linear(1024, 1024), nn.Tanh(),
                              nn.Linear(1024, 1))
        opt = getattr(bf, kind)(torch.optim.SGD(model.parameters(), lr=0.01),
                                model, lambda m, b: (m(b) ** 2).mean())
        opt.step(x)
        ranges, tid = profiled_ranges(lambda: opt.step(x))
        spans = sorted((a, -b, name) for name, ivs in ranges.items()
                       if name.startswith(kind + ".")
                       for a, b, t in ivs if t == tid)
        out[f"{kind}:names"] = np.array([n[len(kind) + 1:]
                                         for _, _, n in spans])
        out[f"{kind}:spans"] = np.array([[a, -b] for a, b, _ in spans],
                                        dtype=np.int64)
        before = {c: metrics.counter(c).value for c in counters}
        opt.step(x)
        after = {c: metrics.counter(c).value for c in before}
        # the best of a few steps: the suite shares its cores, and a rank
        # descheduled between two spans is the host's pause, not the step's
        rep = bf.step_report()
        for _ in range(4):
            opt.step(x)
            rep = max(rep, bf.step_report(), key=lambda r: r["coverage"])
        out[f"{kind}:coverage"] = np.array(rep["coverage"])
        out[f"{kind}:step_sec"] = np.array(rep["step_sec"])
        out[f"{kind}:phases"] = np.array([rep["phases"][p] for p in (
            "local", "pack", "wire", "fold", "unpack")])
        out[f"{kind}:bytes"] = np.array(
            after["opt.combine_bytes"] - before["opt.combine_bytes"])
        out[f"{kind}:sends"] = np.array(
            after["opt.combine_sends"] - before["opt.combine_sends"])
        out[f"{kind}:plan_builds"] = np.array(
            after["opt.plan_builds"] - before["opt.plan_builds"])
        out[f"{kind}:flat_bytes"] = np.array(
            sum(p.numel() * p.element_size() for p in model.parameters()))
        plan = opt._plan()
        out[f"{kind}:shifts"] = np.array(
            -1 if plan is None else len(plan.shifts))
    return out


def _vision(bf, torch, rank: int, world: int, inp) -> dict:
    """ResNet18 under DistributedNeighborAllreduceOptimizer around SGD
    (lr 0.1, momentum 0.9), this rank's images; the flax variables come in
    as ``v:<collection>/<path>`` leaves."""
    from bluefog_tpu_torch.utils import params_from_jax

    model = bf.models.ResNet18(num_filters=int(inp["num_filters"]),
                               num_classes=int(inp["num_classes"]),
                               dtype=torch.float32, device="cpu")
    variables = {k[len("v:"):]: v for k, v in inp.items()
                 if k.startswith("v:")}
    model.load_state_dict(params_from_jax(_unflatten(variables)))
    opt = bf.DistributedNeighborAllreduceOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), model,
        bf.models.classification_loss)
    batch = (torch.from_numpy(inp["images"][rank]),
             torch.from_numpy(inp["labels"][rank]))
    losses = [float(opt.step(batch)["loss"])
              for _ in range(int(inp["steps"]))]
    out = {f"sd:{k}": v.detach().numpy() for k, v in
           model.state_dict().items()}
    out["losses"] = np.asarray(losses)
    return out


def _subgroup(bf, torch, rank: int, world: int, inp) -> dict:
    """``spmd_combine`` over the subgroups {0, 2} and {1, 3}, whose group
    ranks (0 and 1) are not their global ranks, with the shift and the
    gather strategies."""
    import torch.distributed as dist

    from bluefog_tpu_torch.ops.plan import CombinePlan, spmd_combine

    groups = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    plan = CombinePlan(inp["W"])
    x = torch.from_numpy(inp["x"][rank])
    out = {}
    for key, gather in (("shift", False), ("gather", True)):
        (out[key],) = spmd_combine(
            plan.W if gather else plan.rows, [x], rank=rank // 2, n=2,
            shifts=plan.shifts, use_gather=gather, group=groups[rank % 2])
    return {k: v.numpy() for k, v in out.items()}


def _raises(exc, fn, match: str) -> int:
    """1 when ``fn()`` raises ``exc`` with ``match`` in its message."""
    try:
        fn()
    except exc as e:
        return int(match in str(e))
    return 0


def _collectives(bf, torch, rank: int, world: int, inp) -> dict:
    """Every op of the collectives surface on this rank's inputs: the
    blocking, nonblocking and in-place forms, and the error paths."""
    import time

    n = world
    x = torch.from_numpy(inp["x"][rank])
    xb = x.to(torch.bfloat16)
    ragged = torch.from_numpy(inp[f"ragged_{rank}"])
    pairs = {r: r ^ 1 for r in range(n)}
    self_pairs = list(range(n))
    self_pairs[1], self_pairs[2] = 2, 1
    machine_w = dict(self_weight=0.75,
                     neighbor_machine_weights={0: {1: 0.25}, 1: {0: 0.25}},
                     send_neighbor_machines={0: [1], 1: [0]})
    out = {
        "layout": np.array([bf.local_size(), bf.local_rank(),
                            bf.num_machines(), bf.machine_size(),
                            bf.is_homogeneous()]),
        "hier_local_avg": bf.allreduce(x, is_hierarchical_local=True),
        "hier_local_sum": bf.allreduce(x, average=False,
                                       is_hierarchical_local=True),
        "hier_local_bf16": bf.allreduce(xb, is_hierarchical_local=True),
        "allgather": bf.allgather(x),
        "allgather_bf16": bf.allgather(xb),
        "allgather_v": bf.allgather_v(ragged),
        "allgather_v_empty": bf.allgather_v(torch.zeros((0, 3))),
        "hier": bf.hierarchical_neighbor_allreduce(x),
        "hier_weights": bf.hierarchical_neighbor_allreduce(x, **machine_w),
        "hier_bf16": bf.hierarchical_neighbor_allreduce(xb),
        "nag_expo2": bf.neighbor_allgather(x),
        "pair": bf.pair_gossip(x, pairs),
        "pair_w": bf.pair_gossip(x, pairs, 0.75, 0.25),
        "pair_bf16": bf.pair_gossip(xb, pairs, 0.75, 0.25),
        "pair_bf16_odd": bf.pair_gossip(xb, pairs, 0.3, 0.7),
        "pair_self": bf.pair_gossip(x, self_pairs, 0.75, 0.25),
    }
    bf.set_topology(bf.topology_util.StarGraph(n))
    out["nag_star"] = bf.neighbor_allgather(x)
    h = bf.neighbor_allgather_nonblocking(x)
    while not bf.poll(h):
        time.sleep(0.001)
    out["nb_nag_star"] = bf.synchronize(h)
    bf.set_topology(bf.topology_util.ExponentialTwoGraph(n))

    issued = {
        "nb_allreduce": bf.allreduce_nonblocking(x),
        "nb_hier_local": bf.allreduce_nonblocking(
            x, is_hierarchical_local=True),
        "nb_broadcast": bf.broadcast_nonblocking(x, 1),
        "nb_allgather": bf.allgather_nonblocking(x),
        "nb_allgather_v": bf.allgather_v_nonblocking(ragged),
        "nb_pair": bf.pair_gossip_nonblocking(x, pairs, 0.75, 0.25),
        "nb_nar": bf.neighbor_allreduce_nonblocking(x),
        "nb_hier": bf.hierarchical_neighbor_allreduce_nonblocking(x),
        "nb_nag_expo2": bf.neighbor_allgather_nonblocking(x),
    }
    for key, h in issued.items():
        while not bf.poll(h):
            time.sleep(0.001)
        out[key] = bf.wait(h, timeout=60.0) if key == "nb_nar" else \
            bf.synchronize(h)
    flags = {"nb_second_synchronize": _raises(
        ValueError, lambda: bf.synchronize(issued["nb_allreduce"]),
        "already-synchronized")}

    # the in-place forms write into their input and return it
    for key, fn in (
            ("inplace_allreduce", lambda y: bf.allreduce_(y)),
            ("inplace_hier_local", lambda y: bf.allreduce_(
                y, is_hierarchical_local=True)),
            ("inplace_broadcast", lambda y: bf.broadcast_(y, 1)),
            ("inplace_nb_allreduce",
             lambda y: bf.synchronize(bf.allreduce_nonblocking_(y))),
            ("inplace_nb_broadcast",
             lambda y: bf.synchronize(bf.broadcast_nonblocking_(y, 1)))):
        y = x.clone()
        flags[f"{key}_is_input"] = int(fn(y) is y)
        out[key] = y
    pair = [x.clone(), x.clone() + 1]
    flags["inplace_list_is_input"] = int(bf.allreduce_(pair) is pair)
    out["inplace_list_0"], out["inplace_list_1"] = pair

    # a deadline that passes keeps the handle for a retry: rank 0 issues
    # an allreduce that cannot finish before the others join it
    if rank == 0:
        h = bf.allreduce_nonblocking(x)
        flags["timeout_raises"] = _raises(
            RuntimeError, lambda: bf.synchronize(h, timeout=0.05),
            "deadline")
        out["timeout_retry"] = bf.synchronize(h)
    else:
        time.sleep(0.5)
        out["timeout_retry"] = bf.allreduce(x)
        flags["timeout_raises"] = 1

    bad = torch.zeros((1, 5 if rank == 3 else 2))
    flags["allgather_v_mismatch"] = _raises(
        ValueError, lambda: bf.allgather_v(bad), "trailing shape")
    flags["allgather_mismatch"] = _raises(
        ValueError, lambda: bf.allgather(torch.zeros((1 + rank % 2, 2))),
        "equal shapes")
    flags["pair_mismatch"] = _raises(
        ValueError, lambda: bf.pair_gossip(x, {r: (r + 1) % n
                                                for r in range(n)}), "mutual")
    flags["nag_needs_dim"] = _raises(
        ValueError, lambda: bf.neighbor_allgather(torch.tensor(1.0)),
        ">= 1 dim")
    out = {k: v.float().numpy() if torch.is_tensor(v) else v
           for k, v in out.items()}
    out.update({f"flag:{k}": np.array(v) for k, v in flags.items()})
    return out


def _shard(a, rank: int, world: int):
    """Rank ``rank``'s slice of ``a`` along the sequence (dim 1)."""
    s = a.shape[1] // world
    return a[:, rank * s:(rank + 1) * s]


def _context(bf, torch, rank: int, world: int, inp) -> dict:
    """Ring (einsum and flash) and Ulysses attention on this rank's shards
    of the global q, k, v, with the gradients of ``sum(out * g)``; the
    cross-length and bf16 rings; the shape checks; ``cp_apply`` and
    ``cp_loss_fn`` (loss and every parameter gradient) on the small LM of
    ``inp``'s config and flax weights."""
    P = bf.parallel
    q, k, v, g = (torch.from_numpy(_shard(inp[x], rank, world))
                  for x in "qkvg")
    out, flags = {}, {}

    def run(key, fn, causal):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        o = fn(qq, kk, vv, causal=causal)
        o.backward(g)
        out[key] = o
        out[f"{key}_dq"], out[f"{key}_dk"], out[f"{key}_dv"] = \
            qq.grad, kk.grad, vv.grad

    for causal in (0, 1):
        for kind, flash in (("einsum", False), ("flash", True)):
            run(f"ring_{kind}_{causal}",
                lambda *a, **kw: P.ring_attention(*a, use_flash=flash, **kw),
                bool(causal))
        run(f"ulysses_{causal}", P.ulysses_attention, bool(causal))
    qx, kx, vx = (torch.from_numpy(_shard(inp[f"{x}x"], rank, world))
                  for x in "qkv")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    for kind, flash in (("einsum", False), ("flash", True)):
        out[f"cross_{kind}"] = P.ring_attention(qx, kx, vx, use_flash=flash)
        bf16 = P.ring_attention(qb, kb, vb, causal=True, use_flash=flash)
        flags[f"bf16_{kind}_dtype"] = int(bf16.dtype == torch.bfloat16)
        out[f"bf16_{kind}"] = bf16
    # rank 3 holds one token fewer: every rank must raise, none hang
    bad = q[:, :-1] if rank == 3 else q
    flags["bad_seq_ring"] = _raises(
        ValueError, lambda: P.ring_attention(bad, bad, bad), "must divide")
    flags["bad_seq_ulysses"] = _raises(
        ValueError, lambda: P.ulysses_attention(bad, bad, bad), "must divide")
    six = q[:, :, :6]
    flags["bad_heads_ulysses"] = _raises(
        ValueError, lambda: P.ulysses_attention(six, six, six), "heads")

    model = _flash_lm(bf, torch, inp)
    toks = torch.from_numpy(_shard(inp["tokens"], rank, world)).long()
    tgts = torch.from_numpy(_shard(inp["targets"], rank, world)).long()
    for kind in ("ring", "ulysses"):
        with torch.no_grad():
            out[f"cp_apply_{kind}"] = P.cp_apply(model, toks, kind=kind)
        model.zero_grad(set_to_none=True)
        loss = P.cp_loss_fn(model, kind=kind)(model, (toks, tgts))
        loss.backward()
        out[f"cp_loss_{kind}"] = loss
        out.update({f"cp_grad_{kind}:{name}": p.grad
                    for name, p in model.named_parameters()})
    out = {k: v.detach().float().numpy() for k, v in out.items()}
    out.update({f"flag:{k}": np.array(v) for k, v in flags.items()})
    return out


def _checkpoint(bf, torch, rank: int, world: int, inp) -> dict:
    """Save and restore at world ``world`` into the run directory: the
    decentralized optimizer around SGD with momentum (each rank pulled to
    its own target, so every rank's state differs), ``save_async`` with
    the parameters changed right after it, ZeRO-1 around Adam (each rank's
    shard state differs), and a bare DCP save of the same per-rank
    parameters under one key (the trap the rank keys avoid)."""
    import torch.distributed.checkpoint as dcp
    from torch import nn

    ck = bf.checkpoint
    here = os.getcwd()

    class Leaves(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.zeros(4))
            self.b = nn.Parameter(torch.full((3,), 2.0))

    def loss_fn(model, t):
        return 0.5 * ((model.w - t) ** 2).sum() + \
            0.5 * ((model.b - t[:3]) ** 2).sum()

    target = torch.from_numpy(inp["targets"][rank])

    def sgd():
        model = Leaves()
        return bf.DistributedNeighborAllreduceOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), model,
            loss_fn)

    def zero1():
        model = Leaves()
        return bf.DistributedShardedAllreduceOptimizer(
            torch.optim.Adam(model.parameters(), lr=0.1), model, loss_fn)

    def state(opt):
        got = {f"p_{n}": p.detach().clone()
               for n, p in opt.model.named_parameters()}
        for i, entry in opt.base.state_dict()["state"].items():
            got.update({f"s{i}_{n}": t.clone() for n, t in entry.items()
                        if torch.is_tensor(t)})
        return got

    out = {}
    for key, make in (("sgd", sgd), ("zero1", zero1)):
        opt = make()
        for _ in range(3):
            opt.step(target)
        ck.save(os.path.join(here, key), opt, step=3)
        out.update({f"{key}:orig:{n}": t for n, t in state(opt).items()})
        rest, step = ck.restore(os.path.join(here, key), make())
        out[f"{key}:step"] = torch.tensor(step)
        out.update({f"{key}:rest:{n}": t for n, t in state(rest).items()})
        opt.step(target)
        rest.step(target)
        out.update({f"{key}:cont_orig:{n}": t for n, t in state(opt).items()})
        out.update({f"{key}:cont_rest:{n}": t
                    for n, t in state(rest).items()})

    # async: the state at the call is what lands, though the step after it
    # changes the parameters and the momentum at once
    opt = sgd()
    opt.step(target)
    ck.save_async(os.path.join(here, "a1"), opt, step=5)
    out.update({f"a1:want:{n}": t for n, t in state(opt).items()})
    opt.step(target)
    ck.save_async(os.path.join(here, "a2"), opt, step=6)
    out.update({f"a2:want:{n}": t for n, t in state(opt).items()})
    opt.step(target)
    ck.wait_pending()
    for key in ("a1", "a2"):
        rest, step = ck.restore(os.path.join(here, key), sgd())
        out[f"{key}:step"] = torch.tensor(step)
        out.update({f"{key}:got:{n}": t for n, t in state(rest).items()})

    # the trap: one key for every rank's (different) parameters
    w = torch.full((4,), float(rank))
    dcp.save({"w": w}, checkpoint_id=os.path.join(here, "naive"))
    back = {"w": torch.zeros(4)}
    dcp.load(back, checkpoint_id=os.path.join(here, "naive"))
    out["naive_w"] = back["w"]
    return {k: v.detach().float().numpy() for k, v in out.items()}


def _expert(bf, torch, rank: int, world: int, inp) -> dict:
    """Expert parallelism on this rank's tokens: ``ep_apply`` (forward at
    several capacity factors, the zero-gate drop cases, gradients of
    ``sum(y * cot) + 0.1 * mean(aux)``, bf16, the checks), then the MoE LM
    of ``lm:<path>`` flax weights through ``ep_lm_apply`` and
    ``ep_lm_loss_fn`` (loss and every gradient), ``ep_lm_init``, and 30
    plain Adam steps."""
    P = bf.parallel
    from bluefog_tpu_torch.utils import params_from_jax

    n = world
    b = inp["x"].shape[0] // n
    x = torch.from_numpy(inp["x"][rank * b:(rank + 1) * b])
    cot = torch.from_numpy(inp["cot"][rank * b:(rank + 1) * b])
    params = {k: torch.from_numpy(inp[f"sw:{k}"]) for k in
              ("gate", "up", "down")}
    zero = dict(params, gate=torch.zeros_like(params["gate"]))
    out, flags = {}, {}
    for cf in inp["capacity_factors"]:
        out[f"fwd_{cf}"], out[f"aux_{cf}"] = P.ep_apply(params, x,
                                                        capacity_factor=cf)
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        xx = x.clone().requires_grad_(True)
        y, aux = P.ep_apply(p, xx, capacity_factor=cf)
        ((y * cot).sum() + 0.1 * aux / n).backward()
        out[f"dx_{cf}"], out[f"dgate_{cf}"] = xx.grad, p["gate"].grad
        out[f"dup_{cf}"] = p["up"].grad[rank]
        out[f"ddown_{cf}"] = p["down"].grad[rank]
        flags[f"other_rows_{cf}"] = int(not any(
            p[k].grad[r].any() for k in ("up", "down") for r in range(n)
            if r != rank))
    for cf in inp["zero_gate_factors"]:
        out[f"zero_{cf}"], out[f"zero_aux_{cf}"] = P.ep_apply(
            zero, x, capacity_factor=cf)
    out["bf16"], _ = P.ep_apply(params, x, capacity_factor=float(n),
                                dtype=torch.bfloat16)
    flags["bf16_dtype"] = int(out["bf16"].dtype == torch.float32)
    flags["bad_experts"] = _raises(
        ValueError, lambda: P.ep_apply(dict(params, up=params["up"][:2]), x),
        "experts")
    bad = x[:1] if rank == 3 else x
    flags["bad_batch"] = _raises(ValueError, lambda: P.ep_apply(params, bad),
                                 "divide")

    cfg = {k: int(inp[k]) for k in ("vocab", "layers", "heads", "d_model",
                                    "d_ff")}

    def lm(seed=0):
        return bf.models.MoETransformerLM(
            vocab_size=cfg["vocab"], num_experts=n, num_layers=cfg["layers"],
            num_heads=cfg["heads"], d_model=cfg["d_model"],
            d_ff=cfg["d_ff"], moe_every=2, expert_axis="expert",
            capacity_factor=float(inp["lm_capacity_factor"]), device="cpu",
            seed=seed)

    model = lm()
    tree = _unflatten({k[len("lm:"):]: v for k, v in inp.items()
                       if k.startswith("lm:")})
    model.load_state_dict(params_from_jax(tree, expert_rank=rank))
    toks = torch.from_numpy(inp["tokens"][rank:rank + 1]).long()
    tgts = torch.from_numpy(inp["targets"][rank:rank + 1]).long()
    with torch.no_grad():
        out["lm_logits"], out["lm_aux"] = P.ep_lm_apply(model, toks)
    loss_fn = P.ep_lm_loss_fn(model)
    loss = loss_fn(model, (toks, tgts))
    loss.backward()
    out["lm_loss"] = loss
    out.update({f"lm_grad:{name}": p.grad
                for name, p in model.named_parameters()})
    flags["lm_wrong_axis"] = _raises(
        ValueError, lambda: P.ep_lm_loss_fn(model, axis="other"),
        "expert_axis")

    seeded = lm(seed=5)
    full = P.ep_lm_init(model, seed=5)
    flags["lm_init_slice"] = int(all(
        torch.equal(v, full[k][rank:rank + 1]) if k.endswith(("up", "down"))
        and ".moe." in k else torch.equal(v, full[k])
        for k, v in model.state_dict().items()))
    flags["lm_seed_is_twin"] = int(all(
        torch.equal(a, b) for a, b in zip(seeded.state_dict().values(),
                                          model.state_dict().values())))

    model.load_state_dict(params_from_jax(tree, expert_rank=rank))
    adam = torch.optim.Adam(model.parameters(), lr=3e-3)
    losses = []
    for _ in range(int(inp["train_steps"])):
        adam.zero_grad(set_to_none=True)
        loss = loss_fn(model, (toks, tgts))
        loss.backward()
        adam.step()
        losses.append(float(loss.detach()))
    out["train_losses"] = torch.tensor(losses)
    out["train_up"] = model.block_1.moe.up
    out["train_head"] = model.lm_head.weight
    out = {k: v.detach().float().numpy() for k, v in out.items()}
    out.update({f"flag:{k}": np.array(v) for k, v in flags.items()})
    return out


def _optimization(bf, torch, rank: int, world: int, inp) -> dict:
    """``examples/optimization.py``'s algorithms on this rank's ``X``, ``y``
    over the ring: every method after ``cmp_steps`` steps (DGD's iterate
    as their ``w_opt``), then the convergence runs at the JAX tests'
    budgets, the two nonblocking handles in flight, and ``push_diging``
    (over windows, 400 iterations)."""
    from bluefog_tpu_torch.examples import optimization as ex

    ex.set_example_topology("ring")
    X, y = (torch.from_numpy(inp[k][rank]) for k in ("X", "y"))
    grad_fn = ex.make_grad_fn(X, y, "linear_regression", 1e-2)
    k = int(inp["cmp_steps"])
    out, flags = {}, {}
    out["cmp_dgd"] = ex.distributed_grad_descent(grad_fn, world, 5,
                                                 maxite=k, alpha=0.1)
    for name, alpha in (("diffusion", 0.05), ("exact_diffusion", 0.1),
                        ("gradient_tracking", 0.05)):
        out[f"cmp_{name}"], _ = ex.ALGORITHMS[name](
            grad_fn, out["cmp_dgd"], world, 5, maxite=k, alpha=alpha)

    w_opt = ex.distributed_grad_descent(grad_fn, world, 5, maxite=400,
                                        alpha=0.1)
    out["w_opt"] = w_opt
    out["w_opt_global_grad"] = bf.allreduce(grad_fn(w_opt), average=True)
    for name, iters, alpha in (("exact_diffusion", 100, 0.1),
                               ("gradient_tracking", 200, 0.05),
                               ("diffusion", 150, 0.05)):
        out[f"conv_{name}"], mse = ex.ALGORITHMS[name](
            grad_fn, w_opt, world, 5, maxite=iters, alpha=alpha)
        out[f"mse_{name}"] = torch.tensor(mse)

    w = torch.zeros((5, 1))
    q = grad_fn(w)
    h1 = bf.neighbor_allreduce_nonblocking(w, name="overlap.w")
    h2 = bf.neighbor_allreduce_nonblocking(q, name="overlap.q")
    flags["overlap_handles_differ"] = int(h1 != h2)
    out["overlap_w"], out["overlap_q"] = bf.synchronize(h1), \
        bf.synchronize(h2)
    out["overlap_q_in"] = q
    out["cmp_push_diging"], _ = ex.push_diging(grad_fn, out["cmp_dgd"],
                                               world, 5, maxite=k,
                                               alpha=0.05)
    out["conv_push_diging"], mse = ex.push_diging(grad_fn, w_opt, world, 5,
                                                  maxite=400, alpha=0.05)
    out["mse_push_diging"] = torch.tensor(mse)
    out = {k: v.detach().float().numpy() for k, v in out.items()}
    out.update({f"flag:{k}": np.array(v) for k, v in flags.items()})
    return out


def _lm(bf, torch, inp, prefix: str):
    """The f32 ``TransformerLM`` of ``inp``'s ``<prefix>cfg`` with the flax
    weights ``<prefix>p:<path>``, dense attention, on the CPU."""
    from bluefog_tpu_torch.utils import params_from_jax

    vocab, layers, heads, d_model, d_ff = (int(v) for v in
                                           inp[prefix + "cfg"])
    model = bf.models.TransformerLM(
        vocab_size=vocab, num_layers=layers, num_heads=heads,
        d_model=d_model, d_ff=d_ff, device="cpu")
    tag = prefix + "p:"
    params = {k[len(tag):]: v for k, v in inp.items() if k.startswith(tag)}
    model.load_state_dict(params_from_jax(_unflatten(params)))
    return model


def _tensor(bf, torch, rank: int, world: int, inp) -> dict:
    """``tp_shard_params``/``tp_apply``/``tp_loss_fn`` over the world as
    one model group (``main``, and ``ff62`` whose d_ff does not divide 4),
    then as 2 x 2 (data x model): model groups {0, 1}, {2, 3}, data groups
    {0, 2}, {1, 3}, rank r at data index r // 2 and model index r % 2."""
    import torch.distributed as dist

    from bluefog_tpu_torch import parallel as P

    groups = {ranks: dist.new_group(list(ranks))
              for ranks in ((0, 1), (2, 3), (0, 2), (1, 3))}
    cases = {"main": ("", None, None, slice(None)),
             "ff62": ("ff62:", None, None, slice(None)),
             "dm": ("", groups[(0, 1) if rank < 2 else (2, 3)],
                    groups[(0, 2) if rank % 2 == 0 else (1, 3)],
                    slice(2 * (rank // 2), 2 * (rank // 2) + 2))}
    out, flags, models = {}, {}, {}
    for case, (prefix, group, data_group, rows) in cases.items():
        model = models[case] = P.tp_shard_params(_lm(bf, torch, inp, prefix),
                                                 group)
        toks = torch.from_numpy(inp["tokens"][rows]).long()
        tgts = torch.from_numpy(inp["targets"][rows]).long()
        with torch.no_grad():
            out[f"{case}:logits"] = P.tp_apply(model, toks, group)
        loss = P.tp_loss_fn(model, group, data_group)(model, (toks, tgts))
        loss.backward()
        out[f"{case}:loss"] = loss.detach()
        for name, p in model.named_parameters():
            out[f"{case}:w:{name}"] = p.detach()
            out[f"{case}:g:{name}"] = p.grad
    # a model sharded over the world refuses a group of another size
    flags["wrong_group"] = _raises(
        ValueError, lambda: P.tp_apply(
            models["main"], toks, groups[(0, 1) if rank < 2 else (2, 3)]),
        "sharded over 4 ranks")
    out = {k: v.detach().float().numpy() for k, v in out.items()}
    out.update({f"flag:{k}": np.array(v) for k, v in flags.items()})
    return out


def _pipeline(bf, torch, rank: int, world: int, inp) -> dict:
    """``pp_apply`` (4 stages x 2 microbatches over the world, then 2 x 4
    over the pipelines {0, 1} and {2, 3}), ``pp_forward_fn`` reused, the
    plain and fused losses and their gradients, the bad-count errors, and
    the training curve of ``pp_train_step_fn`` (2 stages, plain Adam)."""
    import functools

    import torch.distributed as dist

    from bluefog_tpu_torch import parallel as P

    pairs = {ranks: dist.new_group(list(ranks)) for ranks in ((0, 1), (2, 3))}
    pair = pairs[(0, 1) if rank < 2 else (2, 3)]
    model = _lm(bf, torch, inp, "")
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    toks = torch.from_numpy(inp["tokens"]).long()
    tgts = torch.from_numpy(inp["targets"]).long()
    out, flags = {}, {}
    with torch.no_grad():
        out["apply_4_2"] = P.pp_apply(model, sd, toks, n_micro=2)
        out["apply_2_4"] = P.pp_apply(model, sd, toks, pair, n_micro=4)
    stacked, rest = P.pp_stack_params(sd, 4)
    stage = {k: v.clone().requires_grad_()
             for k, v in P.pp_place_params(stacked).items()}
    rest = {k: v.clone().requires_grad_() for k, v in rest.items()}
    fwd = P.pp_forward_fn(model, n_micro=2)
    with torch.no_grad():
        out["fwd_1"] = fwd(stage, rest, toks)
        out["fwd_2"] = fwd(stage, rest, toks)
    for key, fn in (("plain", P.pp_loss_fn),
                    ("fused", P.pipeline._pp_fused_loss)):
        loss = fn(model, n_micro=2)(stage, rest, (toks, tgts))
        loss.backward()
        out[f"{key}:loss"] = loss.detach()
        for k, t in [*stage.items(), *rest.items()]:
            out[f"{key}:g:{k}"] = t.grad
            t.grad = None
    flags["bad_micro"] = _raises(
        ValueError, lambda: P.pp_apply(model, sd, toks, n_micro=3),
        "microbatch")
    flags["bad_layers"] = _raises(
        ValueError, lambda: P.pp_stack_params(sd, 3), "multiple of")
    two = _lm(bf, torch, inp, "train:")
    batch = (torch.from_numpy(inp["train_tokens"]).long(),
             torch.from_numpy(inp["train_targets"]).long())
    for key, fused in (("plain", False), ("fused", True)):
        stage2, rest2, adam = P.pp_train_init(
            two, pair, {k: v.detach() for k, v in two.state_dict().items()},
            functools.partial(torch.optim.Adam, lr=1e-2))
        step = P.pp_train_step_fn(two, pair, adam, n_micro=2,
                                  fused_loss=fused)
        out[f"curve_{key}"] = torch.stack(
            [step(stage2, rest2, batch) for _ in range(int(inp["steps"]))])
        with torch.no_grad():
            out[f"curve_{key}_logits"] = P.pp_forward_fn(
                two, pair, n_micro=2)(stage2, rest2, batch[0])
    out = {k: v.detach().float().numpy() for k, v in out.items()}
    out.update({f"flag:{k}": np.array(v) for k, v in flags.items()})
    return out


def timeline_ops(bf, x, n: int, make_opt, steps: int = 3):
    """The ops of the timeline test, one package's functions ``bf`` on
    this process's ``x``: the port's, or the JAX package's on rank-stacked
    inputs; ``make_opt()`` returns ``(opt, step)``, the optimizer and a
    function running one of its steps."""
    sends = {r: [(r + 1) % n] for r in range(n)}
    nw = {r: {(r - 1) % n: 0.5} for r in range(n)}
    bf.allreduce(x, name="tl.allreduce")
    bf.broadcast(x, 1, name="tl.broadcast")
    bf.allgather(x, name="tl.allgather")
    bf.neighbor_allreduce(x, name="tl.nar.static")
    # the first dynamic call builds the plan (PLAN_BUILD), the second hits
    bf.neighbor_allreduce(x, self_weight=0.5, neighbor_weights=nw,
                          send_neighbors=sends, name="tl.nar.dyn")
    bf.neighbor_allreduce(x, self_weight=0.5, neighbor_weights=nw,
                          send_neighbors=sends, name="tl.nar.dyn2")
    bf.pair_gossip(x, [r ^ 1 for r in range(n)], name="tl.pair")
    bf.synchronize(bf.allreduce_nonblocking(x, name="tl.nb"))
    with bf.timeline_context("tl.manual", "GRADIENT_COMPUTATION"):
        pass
    opt, step = make_opt()
    for _ in range(steps):
        step()
    return opt


def _timeline(bf, torch, rank: int, world: int, inp) -> dict:
    """The timeline test's ops and 3 optimizer steps with the timeline on
    (``BFT_TIMELINE`` from the parent); the trace file is the output."""
    from torch import nn

    x = torch.from_numpy(inp["x"][rank])

    def make_opt():
        model = nn.Linear(x.shape[-1], 1)
        opt = bf.DistributedNeighborAllreduceOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), model,
            lambda m, b: (m(b) ** 2).mean())
        return opt, lambda: opt.step(x)

    from bluefog_tpu_torch.runtime.logging import _RankPrefixFilter

    opt = timeline_ops(bf, x, world, make_opt)
    return {"step": np.array(opt._counter),
            "timeline_on": np.array(bf.runtime.state._global_state()
                                    .timeline is not None),
            "log_prefix": np.array(_RankPrefixFilter._prefix())}


def _wire(bf, torch, rank: int, world: int, inp) -> dict:
    """Under a control plane the parent serves (``BFT_CP_HOST``/
    ``BFT_CP_PORT``, ``BFT_CP_SERVE=0``, ``BFT_INCARNATION``): 3 optimizer
    steps, a publication, ``cluster_health()`` on every rank, then one
    remote dump trigger bumped by rank 0 and polled twice by each rank."""
    from bluefog_tpu_torch.runtime import control_plane as cp
    from bluefog_tpu_torch.runtime import flight
    from bluefog_tpu_torch.runtime.logging import _RankPrefixFilter

    x = torch.from_numpy(inp["x"][rank])
    model = torch.nn.Linear(x.shape[-1], 1)
    opt = bf.DistributedNeighborAllreduceOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), model,
        lambda m, b: (m(b) ** 2).mean())
    for _ in range(3):
        opt.step(x)
    bf.metrics.publish_now()
    bf.barrier()
    health = bf.cluster_health()
    bf.barrier()
    if rank == 0:
        cp.client().fetch_add(flight.TRIGGER_KEY, 1)
    bf.barrier()
    fired = [flight.poll_remote_trigger(cp.client()) for _ in range(2)]
    return {"active": np.array(cp.active()), "cp_world": np.array(cp.world()),
            "health_steps": np.array([health["ranks"][r]["step"]
                                      for r in range(world)]),
            "health_inc": np.array([health["ranks"][r]["incarnation"]
                                    for r in range(world)]),
            "missing": np.array(len(health["missing"])),
            "fired": np.array(fired),
            "log_prefix": np.array(_RankPrefixFilter._prefix())}


def _peer_lost(bf, torch, rank: int, world: int, inp) -> dict:
    """Failure detection under a control plane the parent serves, with a
    fast heartbeat: after a barrier rank ``victim`` SIGKILLs itself where
    the others issue ``allreduce_nonblocking``, so their op can never
    complete. Each survivor's ``synchronize(timeout)`` must raise
    ``PeerLostError``; it reports the error's ``dead``, ``dead_ranks()``,
    ``dead_controllers()``, the epoch and the seconds the call took. The
    process group is broken then, so the survivors write their outputs
    and leave without the collective teardown."""
    import signal
    import time

    victim = int(inp["victim"])
    epoch0 = bf.membership_epoch()
    bf.barrier()
    if rank == victim:
        os.kill(os.getpid(), signal.SIGKILL)
    h = bf.allreduce_nonblocking(torch.full((4,), float(rank)),
                                 name="doomed")
    t0 = time.monotonic()
    try:
        bf.synchronize(h, timeout=float(inp["sync_timeout"]))
        raise SystemExit("synchronize returned with a peer dead")
    except bf.PeerLostError as exc:
        err = exc
    seconds = time.monotonic() - t0
    # the monitor adds to its dead set before it bumps the epoch (a KV
    # round trip): give the bump a moment to land
    deadline = time.monotonic() + 5.0
    while bf.membership_epoch() <= epoch0 and time.monotonic() < deadline:
        time.sleep(0.01)
    out = {"dead": np.array(sorted(err.dead)),
           "dead_ranks": np.array(sorted(bf.dead_ranks())),
           "dead_controllers": np.array(sorted(bf.dead_controllers())),
           "epoch_rose": np.array(bf.membership_epoch() > epoch0),
           "seconds": np.array(seconds),
           "message": np.array(str(err)),
           "dump": np.array(os.path.exists(f"bf_flight_{rank}.json"))}
    np.savez(os.path.join(os.getcwd(), f"out_{rank}.npz"), **out)
    sys.stdout.flush()
    os._exit(0)


def _topo_check(bf, torch, rank: int, world: int, inp) -> dict:
    """The cross-controller topology check under a control plane the
    parent serves (``BFT_TOPO_CHECK_TIMEOUT``, ``BFT_TOPO_CHECK_REARM`` =
    4). (a) Every rank passes the same dynamic ring shift by one: the
    check agrees, the result is the closed form, its repeat is a cache
    hit. (b) Rank 0 alone passes a different set: every rank's check
    raises (nothing is exchanged). (c) A two-step cyclic schedule agreed
    step by step, then rank 0 one step ahead at the re-arm call: every
    rank's re-arm raises; in step again, the next re-arm agrees."""
    import time

    from bluefog_tpu_torch.runtime import control_plane as cp

    n = world
    x = torch.full((2,), float(rank))

    def step(shift, name):
        return bf.neighbor_allreduce(
            x, self_weight=0.5,
            neighbor_weights={r: {(r - shift) % n: 0.5} for r in range(n)},
            send_neighbors={r: [(r + shift) % n] for r in range(n)},
            name=name)

    def raises(shift, match):
        t0 = time.monotonic()
        try:
            step(shift, "bad")
        except RuntimeError as exc:
            if match not in str(exc):
                raise
            return time.monotonic() - t0
        raise SystemExit(f"shift {shift} was not refused")

    out = {"agreed": step(1, "agreed").numpy(),
           "warm": step(1, "warm").numpy()}
    bf.barrier()
    out["diverged_s"] = np.array(raises(
        2 if rank == 0 else 3, "DIFFERENT dynamic edge sets"))
    bf.barrier()
    # (c) BFT_TOPO_CHECK_REARM=4 counts checked calls since set_topology
    bf.set_topology(bf.topology_util.RingGraph(n))
    step(1, "c1")
    step(2, "c2")
    step(1, "c3")
    out["rearm_s"] = np.array(raises(1 if rank == 0 else 2,
                                     "topology re-check failed"))
    bf.barrier()
    for c, shift in ((5, 1), (6, 2), (7, 1), (8, 2)):
        out[f"c{c}"] = step(shift, f"c{c}").numpy()
    out["tickets"] = np.array(cp.client().get("tc.rearm.tickets"))
    return out


def _sidecar_epoch(bf, torch, rank: int, world: int, inp) -> dict:
    """A checkpoint under a control plane the parent serves: the sidecar
    carries the membership epoch ``bf.membership_epoch()`` reads at the
    save, once the heartbeat's mirror has caught up with the server's
    count (every attach under ``BFT_INCARNATION`` bumps it)."""
    import json
    import time

    from bluefog_tpu_torch.runtime import control_plane as cp

    model = torch.nn.Linear(3, 1)
    opt = bf.DistributedNeighborAllreduceOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), model,
        lambda m, b: (m(b) ** 2).mean())
    opt.step(torch.ones(2, 3))
    bf.barrier()
    deadline = time.monotonic() + 10.0
    while bf.membership_epoch() < cp.membership_epoch_kv() and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    bf.barrier()
    epoch = bf.membership_epoch()
    path = bf.checkpoint.save(os.path.join(os.getcwd(), "ck"), opt, step=1)
    out = {"epoch": np.array(epoch)}
    if rank == 0:
        with open(path + ".bf_meta.json") as f:
            out["meta_epoch"] = np.array(json.load(f)["membership_epoch"])
    return out


def _examples(tmp_dir: str) -> None:
    """Every example of ``bluefog_tpu_torch/examples/`` (but the
    long-context one) through its entry point, in turn, in this rank of a
    ``torchrun`` world on the CPU: one process group for all of them, which
    each ``bf.init`` joins; rank 0 prints their lines."""
    import torch.distributed as dist

    from bluefog_tpu_torch.examples import (average_consensus, benchmark,
                                            mnist, moe, optimization, resnet,
                                            serving)

    cpu = ["--device", "cpu"]
    dist.init_process_group("gloo")
    if average_consensus.main(cpu) != 0:
        raise SystemExit("average consensus failed")
    moe.main(cpu + ["--experts", str(dist.get_world_size())])
    benchmark.main(cpu + ["--model", "mlp", "--batch-size", "8",
                          "--num-warmup-batches", "1",
                          "--num-batches-per-iter", "2", "--num-iters", "2"])
    for kind in ("win_put", "pull_get", "push_sum"):
        benchmark.main(cpu + ["--model", "mlp", "--batch-size", "8",
                              "--num-warmup-batches", "1",
                              "--num-batches-per-iter", "2",
                              "--num-iters", "2", "--dist-optimizer", kind])
    mnist.main(cpu + ["--epochs", "1", "--samples-per-rank", "256"])
    optimization.main(cpu + ["--method", "gradient_tracking", "--task",
                             "linear_regression", "--max-iter", "200"])
    common = cpu + ["--batch-size", "4", "--val-batch-size", "4",
                    "--base-lr", "0.004", "--warmup-epochs", "2",
                    "--steps-per-epoch", "6", "--classes", "4",
                    "--checkpoint-format",
                    os.path.join(tmp_dir, "ck-{epoch}")]
    resnet.train(resnet.parse_args(common + ["--epochs", "2"]))
    resnet.train(resnet.parse_args(common + [
        "--epochs", "3", "--resume-from", os.path.join(tmp_dir, "ck-2")]))
    resnet.train(resnet.parse_args(cpu + [
        "--batch-size", "4", "--val-batch-size", "4", "--base-lr", "0.004",
        "--warmup-epochs", "2", "--steps-per-epoch", "6", "--classes", "4",
        "--epochs", "1", "--dist-optimizer", "win_put"]))
    if serving.main(cpu) != 0:
        raise SystemExit("serving failed")
    dist.destroy_process_group()


def main() -> None:
    if sys.argv[1] == "examples":     # a rank of a torchrun world
        _examples(sys.argv[2])
        return
    mode, rank, world, tmp_dir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    import torch

    import bluefog_tpu_torch as bf
    from _torch_port_frontend_child import frontend
    from _torch_port_win_child import win_hosted, win_ops
    from _torch_port_winopt_child import (winopt_coll, winopt_hosted,
                                          winopt_kill)

    torch.set_num_threads(1)
    inp = dict(np.load(os.path.join(tmp_dir, "inputs.npz")))
    kw = {"local_size": int(inp["local_size"])} if "local_size" in inp \
        else {}
    bf.init(device="cpu", init_method="file://" + os.path.join(
        tmp_dir, "store"), rank=rank, world_size=world, **kw)
    out = {"ops": _ops, "slice": _slice, "vision": _vision,
           "subgroup": _subgroup, "collectives": _collectives,
           "optimizers": _optimizers, "context": _context,
           "checkpoint": _checkpoint, "expert": _expert,
           "optimization": _optimization, "tensor": _tensor,
           "pipeline": _pipeline, "timeline": _timeline,
           "step_spans": _step_spans,
           "wire": _wire, "peer_lost": _peer_lost,
           "topo_check": _topo_check, "sidecar_epoch": _sidecar_epoch,
           "win_ops": win_ops, "win_hosted": win_hosted,
           "winopt_coll": winopt_coll, "winopt_hosted": winopt_hosted,
           "winopt_kill": winopt_kill, "frontend": frontend}[mode](
               bf, torch, rank, world, inp)
    bf.barrier()
    bf.shutdown()
    np.savez(os.path.join(tmp_dir, f"out_{rank}.npz"), **out)


if __name__ == "__main__":
    main()
