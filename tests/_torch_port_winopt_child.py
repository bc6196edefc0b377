"""The window optimizers' world-4 scenarios, one rank per process.

``tests/_torch_port_child.py`` runs these modes (``run_world``):

* ``winopt_coll``: every config of :data:`CONFIGS` on the collective
  plane (no control plane, the optimizers' default ``require_mutex``);
* ``winopt_hosted``: under a control plane of 4 the parent serves, the
  :data:`HOSTED` configs in lockstep (a barrier before each one-sided write
  and before each combine, ``require_mutex=False``: a deterministic order
  to hold against JAX), the :data:`CODEC_CONFIGS` (from replicated
  initial parameters, as training starts), the consensus gauge,
  unsynchronized runs under the default mutex, and the rejoins;
* ``winopt_kill``: rank :data:`VICTIM` SIGKILLs itself after
  :data:`KILL_AT` lockstep steps; the survivors wait (deadline-bounded) for
  the failure detector to name it, then step on the healed graph.

Every config trains :class:`Leaves` (parameters ``b [4]`` and ``w [6, 4]``,
registered in the JAX package's sorted flatten order) with SGD on a
quadratic loss, or on a zero loss where only the gossip moves the values.
The parent computes JAX's 4-device run of the same configs
(``tests/test_torch_port_win_optimizers.py``). This file imports numpy at
the top; the modes import the port.
"""

from __future__ import annotations

import os
import signal
import sys
import time

import numpy as np

N = 4
STEPS = 4
LR = 0.1
TARGET = 28            # the batch: w's 24 targets then b's 4
# name -> (kind, knobs without prefix, num_steps_per_communication,
#          dtype, loss, steps)
CONFIGS = {
    "put": ("put", {}, 1, "f32", "quad", STEPS),
    "put_k2": ("put", {}, 2, "f32", "quad", STEPS),
    "put_leaf": ("put", {"FUSION_THRESHOLD": "0"}, 1, "f32", "quad", STEPS),
    "get": ("get", {}, 1, "f32", "quad", STEPS),
    "get_leaf": ("get", {"FUSION_THRESHOLD": "0"}, 1, "f32", "quad", STEPS),
    "ps": ("pushsum", {}, 1, "f32", "quad", STEPS),
    "ps_k2": ("pushsum", {}, 2, "f32", "quad", STEPS),
    "ps_leaf": ("pushsum", {"FUSION_THRESHOLD": "0"}, 1, "f32", "quad",
                STEPS),
    "put_bf16": ("put", {}, 1, "bf16", "zero", STEPS),
    "ps_bf16": ("pushsum", {}, 1, "bf16", "zero", STEPS),
    "put_s2": ("put", {"WIN_SHARD": "2"}, 1, "f32", "zero", 12),
    "put_s3": ("put", {"WIN_SHARD": "3"}, 1, "f32", "zero", 18),
    "ps_s2": ("pushsum", {"WIN_SHARD": "2"}, 1, "f32", "zero", 40),
}
HOSTED = ("put", "put_k2", "get", "ps", "ps_k2", "put_s2", "ps_s2")
CODEC_CONFIGS = {
    "put_int8": ("put", {"WIN_CODEC": "int8"}, 1, "f32", "quad", STEPS),
    "put_topk": ("put", {"WIN_CODEC": "topk:0.25"}, 1, "f32", "quad",
                 STEPS),
}
CONSENSUS_STEPS = 6
VICTIM = 3
KILL_AT = 2
AFTER_KILL = 2
REJOIN_STEPS = 3
DONOR = 2          # rank 0's first in-neighbour on ExponentialTwoGraph(4)


def inputs(seed: int = 14) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((N, 6, 4)).astype(np.float32),
            "b": rng.standard_normal((N, 4)).astype(np.float32),
            "t": rng.standard_normal((N, TARGET)).astype(np.float32)}


def set_knobs(prefix: str, knobs: dict) -> None:
    for k, v in knobs.items():
        os.environ[prefix + k] = v


def clear_knobs(prefix: str, knobs: dict) -> None:
    for k in knobs:
        os.environ.pop(prefix + k, None)


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

def _leaves_model(torch, b, w, dtype):
    from torch import nn

    class Leaves(nn.Module):
        def __init__(self):
            super().__init__()
            # copies: the inputs stay as they were for the next config
            self.b = nn.Parameter(torch.tensor(b).to(dtype))
            self.w = nn.Parameter(torch.tensor(w).to(dtype))

    return Leaves()


def _loss(torch, kind: str):
    if kind == "zero":
        return lambda m, t: 0.0 * (m.w.sum() + m.b.sum())

    def quad(m, t):
        return 0.5 * ((m.w - t[:24].reshape(6, 4)) ** 2).sum() + \
            0.5 * ((m.b - t[24:]) ** 2).sum()
    return quad


def _classes(bf):
    return {"put": bf.DistributedWinPutOptimizer,
            "get": bf.DistributedPullGetOptimizer,
            "pushsum": bf.DistributedPushSumOptimizer}


def build(bf, torch, rank, inp, name, cfg, b=None, w=None, **kw):
    """``(model, opt)`` of config ``cfg`` for this rank (the knobs stay set
    while the windows are created)."""
    kind, knobs, k, dtype, loss, _ = cfg
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    model = _leaves_model(torch, inp["b"][rank] if b is None else b,
                          inp["w"][rank] if w is None else w, dt)
    set_knobs("BFT_", knobs)
    try:
        opt = _classes(bf)[kind](
            torch.optim.SGD(model.parameters(), lr=LR), model,
            _loss(torch, loss), num_steps_per_communication=k,
            window_prefix=name, **kw)
    finally:
        clear_knobs("BFT_", knobs)
    return model, opt


def result(model, opt, rank, name) -> dict:
    from bluefog_tpu_torch.ops import windows as W

    out = {f"{name}.w": model.w.detach().float().numpy().copy(),
           f"{name}.b": model.b.detach().float().numpy().copy()}
    if type(opt).__name__ == "DistributedPushSumOptimizer":
        win = W._get_window(opt._win_names[0])
        out[f"{name}.p"] = np.array(win.host.read_p_owned()[rank])
    return out


def run_config(bf, torch, rank, inp, name, cfg, require_mutex=None):
    model, opt = build(bf, torch, rank, inp, name, cfg)
    if require_mutex is not None:
        opt.require_mutex = require_mutex
    t = torch.from_numpy(inp["t"][rank])
    for _ in range(cfg[5]):
        opt.step(t)
    out = result(model, opt, rank, name)
    opt.free()
    return out


class Lockstep:
    """Barriers around the window ops the optimizers call: before each
    one-sided write and before each combine, so every deposit of a step has
    landed before any drain and no rank starts the next step's writes
    before every combine of this one."""

    NAMES = ("win_put", "win_get", "win_accumulate", "win_update")

    def __init__(self, barrier) -> None:
        from bluefog_tpu_torch.ops import windows as W

        self.W = W
        self.saved = {n: getattr(W, n) for n in self.NAMES}

        def wrap(fn):
            def inner(*a, **k):
                barrier()
                return fn(*a, **k)
            return inner

        for n in self.NAMES:
            setattr(W, n, wrap(self.saved[n]))

    def close(self) -> None:
        for n, fn in self.saved.items():
            setattr(self.W, n, fn)


def winopt_coll(bf, torch, rank: int, world: int, inp) -> dict:
    """Every config on the collective plane, the default mutex setting
    (which takes no hoisted lock there and passes no mutex to the ops)."""
    from bluefog_tpu_torch.ops import windows as W

    out = {}
    for name, cfg in CONFIGS.items():
        out.update(run_config(bf, torch, rank, inp, name, cfg))
    model, opt = build(bf, torch, rank, inp, "probe", CONFIGS["put"])
    win = W._get_window(opt._win_names[0])
    out["coll_mutex"] = np.array([
        opt.require_mutex, win.hosted, opt._mutex_ok(win),
        type(opt._hoisted_mutex(opt._win_names[0])).__name__
        == "nullcontext"])
    opt.free()
    return out


def _cp_barrier(cl, ranks, tag):
    """A barrier over ``ranks`` through the control plane's counters (the
    process group is broken once a rank dies)."""
    n = len(ranks)
    ticket = cl.fetch_add(f"t.bar.{tag}", 1)
    goal = (ticket // n + 1) * n
    deadline = time.monotonic() + 60.0
    while cl.get(f"t.bar.{tag}") < goal:
        if time.monotonic() > deadline:
            raise RuntimeError(f"barrier {tag} timed out")
        time.sleep(0.002)


def _step_until(cl, opt, t, survivors, flag: str) -> None:
    """The survivors step in lockstep until rank 0 sets ``flag``; the
    lowest survivor reads it once a round and the rest follow its word."""
    ls = Lockstep(lambda: _cp_barrier(cl, survivors, flag))
    lead = min(survivors)
    try:
        deadline = time.monotonic() + 60.0
        for i in range(10**6):
            _cp_barrier(cl, survivors, flag + ".round")
            if _global_rank() == lead:
                cl.put(f"{flag}.go.{i}", 2 if cl.get(flag) else 1)
            _cp_barrier(cl, survivors, flag + ".word")
            if cl.get(f"{flag}.go.{i}") == 2:
                return
            if time.monotonic() > deadline:
                raise RuntimeError(f"{flag} was never set")
            time.sleep(0.1)
            opt.step(t)
    finally:
        ls.close()


def _global_rank() -> int:
    from bluefog_tpu_torch.runtime.state import _global_state

    return _global_state().rank


def _respawn(bf, torch, model, opt, rank):
    """Stand in for this rank's process dying and coming back: its window
    objects vanish (their server keys stay, as a dead process leaves
    them), its parameters restart from zero, and it attaches QUARANTINED
    (a bumped incarnation)."""
    from bluefog_tpu_torch.runtime import heartbeat as hb
    from bluefog_tpu_torch.runtime.state import _global_state

    st = _global_state()
    for nm in opt._win_names:
        st.windows.pop(nm, None)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    hb._q_state.update(pending=True, pid=rank, inc=1, t0=time.monotonic())


def _rejoins(bf, torch, rank: int, inp, tmp: str) -> dict:
    """(1) win-put: rank 0 adopts donor 2's published row and step counter.
    (2) push-sum: donor 2 splits its mass with rank 0 at its next step.
    (3) sharded win-put: rank 0 collects both shards of donor 2 across its
    steps. (4) sharded push-sum: no donor path; the checkpoint re-mints
    p = 1."""
    from bluefog_tpu_torch.ops import windows as W
    from bluefog_tpu_torch.runtime import control_plane as cp
    from bluefog_tpu_torch.runtime import heartbeat as hb
    from bluefog_tpu_torch.runtime import metrics

    cl = cp.client()
    out = {}
    t = torch.from_numpy(inp["t"][rank])
    survivors = [r for r in range(N) if r != 0]

    def lockstep_steps(opt, steps):
        ls = Lockstep(bf.barrier)
        try:
            for _ in range(steps):
                opt.step(t)
        finally:
            ls.close()

    # (1) win-put
    cfg = CONFIGS["put"]
    model, opt = build(bf, torch, rank, inp, "rj.put", cfg)
    opt.require_mutex = False
    lockstep_steps(opt, REJOIN_STEPS)
    bf.barrier()
    if rank == 0:
        _respawn(bf, torch, model, opt, rank)
        model2, opt2 = build(bf, torch, rank, inp, "rj.put", cfg,
                             b=np.zeros(4, np.float32),
                             w=np.zeros((6, 4), np.float32))
        out["put.rejoined_w"] = model2.w.detach().numpy().copy()
        out["put.rejoined_b"] = model2.b.detach().numpy().copy()
        out["put.counter"] = np.array(opt2._counter)
        out["put.quarantine_done"] = np.array(not hb.quarantine_pending())
        opt = opt2
    else:
        out["put.w"] = model.w.detach().numpy().copy()
        out["put.b"] = model.b.detach().numpy().copy()
    bf.barrier()
    opt.free()
    bf.barrier()

    # (2) push-sum: the donor's mass split
    cfg = CONFIGS["ps"]
    model, opt = build(bf, torch, rank, inp, "rj.ps", cfg)
    opt.require_mutex = False
    lockstep_steps(opt, REJOIN_STEPS)
    bf.barrier()
    nm = "rj.ps.0"
    if rank == 0:
        _respawn(bf, torch, model, opt, rank)
        minted0 = metrics.gauge("pushsum.minted").value
        model2, opt2 = build(bf, torch, rank, inp, "rj.ps", cfg,
                             b=np.zeros(4, np.float32),
                             w=np.zeros((6, 4), np.float32))
        win = W._get_window(nm)
        out["ps.rejoiner_row"] = win._rows[0].copy()
        out["ps.rejoiner_p"] = np.array(win.host.read_p_owned()[0])
        out["ps.rejoiner_minted"] = np.array(
            metrics.gauge("pushsum.minted").value)
        out["ps.minted_before"] = np.array(minted0)
        out["ps.rejoined_w"] = model2.w.detach().numpy().copy()
        cl.put("t.rj.ps.done", 1)
        opt = opt2
    else:
        # the survivors step (lockstep among themselves) until the donor
        # has served; the donor records its row and p just before
        win = W._get_window(nm)
        if rank == DONOR:
            serve = opt._serve_rejoin_requests

            def recorded():
                # the row and p just before the serve that splits
                served = cl.get(f"w.{nm}.msdone.0")
                row = win._rows[rank].copy()
                p = win.host.read_p_owned()[rank]
                serve()
                if not served and cl.get(f"w.{nm}.msdone.0"):
                    out["ps.donor_row"], out["ps.donor_p"] = row, np.array(p)
                    out["ps.donor_after_row"] = win._rows[rank].copy()
                    out["ps.donor_after_p"] = np.array(
                        win.host.read_p_owned()[rank])
            opt._serve_rejoin_requests = recorded
        _step_until(cl, opt, t, survivors, "t.rj.ps.done")
    bf.barrier()
    opt.free()
    bf.barrier()

    # (3) sharded win-put: both shards from one donor, across its steps
    cfg = CONFIGS["put_s2"]
    same_w, same_b = inp["w"][0], inp["b"][0]
    model, opt = build(bf, torch, rank, inp, "rj.sh", cfg, b=same_b, w=same_w)
    opt.require_mutex = False
    lockstep_steps(opt, 2)
    bf.barrier()
    if rank == 0:
        _respawn(bf, torch, model, opt, rank)
        model2, opt2 = build(bf, torch, rank, inp, "rj.sh", cfg,
                             b=np.zeros(4, np.float32),
                             w=np.zeros((6, 4), np.float32))
        out["sh.rejoined_w"] = model2.w.detach().numpy().copy()
        out["sh.rejoined_b"] = model2.b.detach().numpy().copy()
        out["sh.shards"] = np.array(sorted(
            opt2._rejoin_shards[("rj.sh.0", 0)]))
        out["sh.rounds"] = np.array([opt2._counter, opt2._comm_rounds])
        cl.put("t.rj.sh.done", 1)
        opt = opt2
    else:
        _step_until(cl, opt, t, survivors, "t.rj.sh.done")
        out["sh.w"] = model.w.detach().numpy().copy()
    bf.barrier()
    opt.free()
    bf.barrier()

    # (4) sharded push-sum: the checkpoint fallback re-mints p = 1
    cfg = CONFIGS["ps_s2"]
    model, opt = build(bf, torch, rank, inp, "rj.ck", cfg)
    opt.require_mutex = False
    lockstep_steps(opt, 2)
    ck = os.path.join(tmp, "ck")
    bf.checkpoint.save(os.path.join(ck, "ck-2"), opt, step=2)
    out["ck.saved_w"] = model.w.detach().numpy().copy()
    lockstep_steps(opt, 1)
    bf.barrier()
    if rank == 0:
        _respawn(bf, torch, model, opt, rank)
        os.environ["BFT_CHECKPOINT_DIR"] = ck
        try:
            model2, opt2 = build(bf, torch, rank, inp, "rj.ck", cfg,
                                 b=np.zeros(4, np.float32),
                                 w=np.zeros((6, 4), np.float32))
        finally:
            del os.environ["BFT_CHECKPOINT_DIR"]
        win = W._get_window("rj.ck.0")
        out["ck.rejoined_w"] = model2.w.detach().numpy().copy()
        out["ck.p"] = np.array(win.host.read_p_owned()[0])
        out["ck.minted"] = np.array(metrics.gauge("pushsum.minted").value)
        out["ck.counter"] = np.array(opt2._counter)
        opt = opt2
    bf.barrier()
    opt.free()
    return out


def winopt_hosted(bf, torch, rank: int, world: int, inp) -> dict:
    from bluefog_tpu_torch.ops import windows as W
    from bluefog_tpu_torch.runtime import metrics

    out = {}
    # the plane and its mutexes
    model, opt = build(bf, torch, rank, inp, "probe", CONFIGS["put"])
    win = W._get_window(opt._win_names[0])
    out["hosted_mutex"] = np.array([win.hosted, opt._mutex_ok(win)])
    opt.free()
    # lockstep configs and codecs, held against JAX
    ls = Lockstep(bf.barrier)
    try:
        for name in HOSTED:
            out.update(run_config(bf, torch, rank, inp, "h." + name,
                                  CONFIGS[name], require_mutex=False))
        for name, cfg in CODEC_CONFIGS.items():
            # replicated initial parameters, as training starts: the
            # error-feedback references and the mailbox slots start equal
            model, opt = build(bf, torch, rank, inp, name, cfg,
                               b=inp["b"][0], w=inp["w"][0])
            opt.require_mutex = False
            t = torch.from_numpy(inp["t"][rank])
            for _ in range(cfg[5]):
                opt.step(t)
            out.update(result(model, opt, rank, name))
            out[f"{name}.ef"] = np.array(opt.ef_residual_norm())
            opt.free()
        # the consensus gauge, every step, against the numpy oracle
        model, opt = build(bf, torch, rank, inp, "cons",
                           ("put", {}, 1, "f32", "zero", CONSENSUS_STEPS))
        opt.require_mutex = False
        gauges = []
        t = torch.from_numpy(inp["t"][rank])
        for _ in range(CONSENSUS_STEPS):
            opt._consensus_t = 0.0
            opt.step(t)
            gauges.append(metrics.gauge("opt.consensus_dist").value)
        out["cons.gauges"] = np.array(gauges)
        opt.free()
        metrics.gauge("opt.consensus_dist").set(-1.0)
        model, opt = build(bf, torch, rank, inp, "cons.ps", CONFIGS["ps"])
        opt.require_mutex = False
        opt._consensus_t = 0.0
        opt.step(t)
        out["cons.ps_gauge"] = np.array(
            metrics.gauge("opt.consensus_dist").value)
        opt.free()
    finally:
        ls.close()
    # unsynchronized, under the default mutex: the hoisted acquisition
    # around each step's put+update, no barrier at all
    model, opt = build(bf, torch, rank, inp, "mx.put", CONFIGS["put"])
    t = torch.from_numpy(inp["t"][rank])
    for _ in range(5):
        opt.step(t)
    out["mx.put.finite"] = np.array(bool(torch.isfinite(model.w).all()))
    bf.barrier()
    opt.free()
    model, opt = build(bf, torch, rank, inp, "mx.ps", CONFIGS["ps"])
    for _ in range(5):
        opt.step(t)
    bf.barrier()
    nm = opt._win_names[0]
    bf.win_fence(nm)
    win = W._get_window(nm)
    out["mx.ps.p_all"] = win.host.read_p()
    out["mx.ps.p_mail"] = np.array(
        win.host.read_p_mail_owned()[rank].sum())
    bf.barrier()
    opt.free()
    out.update(_rejoins(bf, torch, rank, inp, os.getcwd()))
    return out


def winopt_kill(bf, torch, rank: int, world: int, inp) -> dict:
    """Rank VICTIM dies after KILL_AT lockstep steps of win-put; each
    survivor waits for the failure detector to name it, then takes
    AFTER_KILL lockstep steps (a control-plane barrier over the survivors)
    on the healed graph."""
    from bluefog_tpu_torch.runtime import control_plane as cp
    from bluefog_tpu_torch.runtime import metrics

    cl = cp.client()
    cfg = CONFIGS["put"]
    model, opt = build(bf, torch, rank, inp, "kill", cfg)
    opt.require_mutex = False
    t = torch.from_numpy(inp["t"][rank])
    everyone = list(range(N))
    ls = Lockstep(lambda: _cp_barrier(cl, everyone, "all"))
    try:
        for _ in range(KILL_AT):
            opt.step(t)
    finally:
        ls.close()
    _cp_barrier(cl, everyone, "before")
    if rank == VICTIM:
        os.kill(os.getpid(), signal.SIGKILL)
    deadline = time.monotonic() + 30.0
    while VICTIM not in bf.dead_ranks():
        if time.monotonic() > deadline:
            raise RuntimeError("the failure detector never named the victim")
        time.sleep(0.02)
    survivors = [r for r in everyone if r != VICTIM]
    ls = Lockstep(lambda: _cp_barrier(cl, survivors, "surv"))
    try:
        for _ in range(AFTER_KILL):
            opt.step(t)
    finally:
        ls.close()
    counters = metrics.snapshot()["counters"]
    out = {"kill.w": model.w.detach().numpy().copy(),
           "kill.b": model.b.detach().numpy().copy(),
           "kill.counters": np.array([
               counters.get("opt.healed_rebuilds", 0),
               counters.get("opt.gossip_retries", 0)]),
           "kill.dead": np.array(sorted(bf.dead_ranks()))}
    _cp_barrier(cl, survivors, "end")
    np.savez(os.path.join(os.getcwd(), f"out_{rank}.npz"), **out)
    sys.stdout.flush()
    os._exit(0)
