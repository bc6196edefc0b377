"""The window scenarios the port's world-4 tests and the JAX package share.

``run_scenarios(api, inp, topo)`` runs the counterparts of
``tests/test_win_ops.py`` through ``api``: the port's children
(``tests/_torch_port_child.py`` modes ``win_ops`` and ``win_hosted``) pass
an adapter for one process's rank, the test passes one for the JAX
package's rank-stacked arrays. Each scenario's output is keyed by name: a
rank's array from a child, the ``[n, ...]`` stack from JAX. This file
imports numpy only.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

PUSHSUM_ROUNDS = 8
# the hosted one-sided properties (tests/_onesided_child.py, shortened):
# two ranks asleep while two gossip; a skewed push-sum
SLEEP_S = 3.0
SLEEP_BOUND_S = 2.5
FAST_ROUNDS, SLOW_ROUNDS, SLOW_SLEEP_S = 12, 4, 0.3


def _nested(n, fn):
    """{rank: {peer: w}} from fn(rank) -> {peer: w}."""
    return {r: fn(r) for r in range(n)}


def run_scenarios(api, inp, topo: str, mutex: bool = False) -> dict:
    """The test_win_ops.py counterparts on the current topology (``topo``
    names the keys). ``mutex``: the ops that take it pass
    ``require_mutex=True`` (a control plane is attached)."""
    bf, n = api.bf, api.n
    x = inp["x"]
    out = {}

    def key(k):
        return f"{topo}.{k}"

    def name(k):
        return f"{topo}.{k}"

    in_nbrs = {r: bf.in_neighbor_ranks(r) for r in range(n)}
    out_nbrs = {r: bf.out_neighbor_ranks(r) for r in range(n)}

    # initial buffers are copies of the tensor: update returns it
    assert bf.win_create(api.mk(x), name("init"))
    out[key("initial")] = api.out(bf.win_update(name("init")))
    bf.win_free(name("init"))

    # every rank puts, then the uniform neighbour average
    assert bf.win_create(api.mk(x), name("put"))
    assert bf.win_put(api.mk(x), name("put"))
    api.sync()
    out[key("put_update")] = api.out(bf.win_update(name("put")))
    bf.win_free(name("put"))

    assert bf.win_create(api.mk(x), name("zero"), zero_init=True)
    out[key("zero_init")] = api.out(bf.win_update(name("zero")))
    bf.win_free(name("zero"))

    # a dynamic partial-destination put: only the right neighbour, weight 2
    assert bf.win_create(api.mk(x), name("part"), zero_init=True)
    bf.win_put(api.mk(x), name("part"),
               dst_weights=_nested(n, lambda r: {(r + 1) % n: 2.0}))
    api.sync()
    out[key("partial_put")] = api.out(bf.win_update(
        name("part"), self_weight=0.5,
        neighbor_weights=_nested(n, lambda r: {(r - 1) % n: 0.25})))
    bf.win_free(name("part"))

    assert bf.win_create(api.mk(x), name("clone"), zero_init=True)
    out[key("clone_1")] = api.out(bf.win_update(name("clone"), clone=True))
    out[key("clone_2")] = api.out(bf.win_update(name("clone"), clone=True))
    bf.win_free(name("clone"))

    assert bf.win_create(api.mk(x), name("coll"), zero_init=True)
    bf.win_put(api.mk(x), name("coll"))
    api.sync()
    out[key("collect_1")] = api.out(bf.win_update_then_collect(
        name("coll"), require_mutex=mutex))
    out[key("collect_2")] = api.out(bf.win_update_then_collect(
        name("coll"), require_mutex=mutex))
    bf.win_free(name("coll"))

    # stacked accumulates
    assert bf.win_create(api.mk(x), name("acc"), zero_init=True)
    bf.win_accumulate(api.mk(x), name("acc"))
    bf.win_accumulate(api.mk(x), name("acc"))
    api.sync()
    out[key("accumulate")] = api.out(bf.win_update(
        name("acc"), self_weight=0.0,
        neighbor_weights=_nested(n, lambda r: {s: 1.0 for s in in_nbrs[r]})))
    bf.win_free(name("acc"))

    # push-sum self down-weighting: half kept, half to the right neighbour
    ones = np.ones_like(x)
    assert bf.win_create(api.mk(ones), name("sws"), zero_init=True)
    bf.win_accumulate(api.mk(ones), name("sws"), self_weight=0.5,
                      dst_weights=_nested(n, lambda r: {(r + 1) % n: 0.5}))
    api.sync()
    out[key("self_weight_scaling")] = api.out(bf.win_update_then_collect(
        name("sws"), require_mutex=mutex))
    bf.win_free(name("sws"))

    assert bf.win_create(api.mk(x), name("get"), zero_init=True)
    assert bf.win_get(name("get"))
    # a neighbour's update republishes its row: every get first
    api.sync()
    out[key("get")] = api.out(bf.win_update(name("get")))
    bf.win_free(name("get"))

    assert bf.win_create(api.mk(x), name("getw"), zero_init=True)
    bf.win_get(name("getw"),
               src_weights=_nested(n, lambda r: {(r - 1) % n: 2.0}))
    api.sync()
    out[key("get_weights")] = api.out(bf.win_update(
        name("getw"), self_weight=1.0,
        neighbor_weights=_nested(n, lambda r: {(r - 1) % n: 1.0})))
    bf.win_free(name("getw"))

    # versions: 0, 1, 2 puts, then an update reads every slot
    assert bf.win_create(api.mk(x), name("ver"))
    api.sync()
    vers = [api.versions(name("ver"))]
    api.sync()
    bf.win_put(api.mk(x), name("ver"))
    api.sync()
    vers.append(api.versions(name("ver")))
    api.sync()
    bf.win_put(api.mk(x), name("ver"),
               dst_weights=_nested(n, lambda r: {(r + 1) % n: 1.0}))
    api.sync()
    vers.append(api.versions(name("ver")))
    api.sync()
    bf.win_update(name("ver"))
    api.sync()
    vers.append(api.versions(name("ver")))
    out[key("versions")] = np.stack(vers, axis=-2)
    bf.win_free(name("ver"))

    # push-sum: one out-neighbour per round gets half the mass
    bf.turn_on_win_ops_with_associated_p()
    try:
        assert bf.win_create(api.mk(x), name("ps"), zero_init=True)
        cur = api.mk(x)
        for it in range(PUSHSUM_ROUNDS):
            bf.win_accumulate(
                cur, name("ps"), self_weight=0.5,
                dst_weights=_nested(n, lambda r: {
                    out_nbrs[r][it % len(out_nbrs[r])]: 0.5}),
                require_mutex=mutex)
            api.sync()
            cur = bf.win_update_then_collect(name("ps"), require_mutex=mutex)
            api.sync()
        out[key("pushsum")] = api.out(cur)
        out[key("pushsum_p")] = api.p(name("ps"))
        bf.win_free(name("ps"))
    finally:
        bf.turn_off_win_ops_with_associated_p()

    # an integer window with fractional weights (the mailbox stores f32)
    xi = (np.arange(n, dtype=np.int32)[:, None] * 8 *
          np.ones((1, x.shape[1]), np.int32))
    assert bf.win_create(api.mk(xi), name("int"))
    bf.win_put(api.mk(xi), name("int"),
               dst_weights={r: 0.5 for r in range(n)})
    api.sync()
    out[key("int_window")] = api.out(bf.win_update(
        name("int"), self_weight=0.0,
        neighbor_weights=_nested(n, lambda r: {s: 1.0 for s in in_nbrs[r]})))
    bf.win_free(name("int"))

    # bf16: the same put/update, f32 accumulation
    assert bf.win_create(api.mk(x, "bf16"), name("bf16"))
    bf.win_put(api.mk(x, "bf16"), name("bf16"), self_weight=0.75)
    api.sync()
    out[key("bf16")] = api.out(bf.win_update(name("bf16")))
    bf.win_free(name("bf16"))

    # the nonblocking forms through poll / wait
    assert bf.win_create(api.mk(x), name("nb"), zero_init=True)
    h = bf.win_put_nonblocking(api.mk(x), name("nb"), self_weight=0.5)
    while not bf.win_poll(h):
        time.sleep(0.001)
    assert bf.win_wait(h)
    h = bf.win_accumulate_nonblocking(api.mk(x), name("nb"))
    assert bf.win_wait(h)
    # the fence folds every deposit before the get overwrites the slots
    assert bf.win_fence(name("nb"))
    h = bf.win_get_nonblocking(name("nb"))
    assert bf.win_wait(h)
    api.sync()
    out[key("nonblocking")] = api.out(bf.win_update(name("nb")))
    bf.win_free(name("nb"))
    return out


def lifecycle(bf, mk, x) -> dict:
    """TestWinLifecycle: create/duplicate/free flags, free-all, unknown."""
    flags = [bf.win_create(mk(x), "w1"), bf.win_create(mk(x), "w1"),
             bf.win_free("w1"), bf.win_free("w1")]
    bf.win_create(mk(x), "a")
    bf.win_create(mk(x), "b")
    flags.append(bf.win_free())
    flags.append(bf.win_create(mk(x), "a"))
    # the topology is frozen while windows exist
    flags.append(bf.set_topology(bf.topology_util.RingGraph(bf.size())))
    with bf.win_lock("a"):
        pass
    bf.win_free("a")
    try:
        bf.win_update("nope")
        flags.append(False)
    except ValueError as exc:
        flags.append("does not exist" in str(exc))
    try:
        with bf.win_lock("nope"):
            pass
        flags.append(False)
    except ValueError:
        flags.append(True)
    return {"lifecycle": np.array(flags)}


def port_api(bf, torch, rank: int):
    """The adapter for one process of the port."""

    class Api:
        n = bf.size()

        @staticmethod
        def mk(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a[rank]))
            return t.to(torch.bfloat16) if dtype == "bf16" else t

        @staticmethod
        def out(t):
            return t.float().numpy() if t.dtype == torch.bfloat16 \
                else t.numpy()

        @staticmethod
        def versions(name):
            v = bf.get_win_version(name)
            return np.array([v[s] for s in sorted(v)], np.int64)

        @staticmethod
        def p(name):
            return np.array(bf.win_associated_p(name))

        @staticmethod
        def sync():
            """Hosted ops are one-sided: meet between a write and a read
            of another rank's state (a deposit, a version, a published
            row), as one controller's sequence of ops is ordered in JAX
            (not needed on the lockstep collective plane)."""
            if hosted[0]:
                bf.barrier()

    hosted = [False]
    Api.hosted = hosted
    Api.bf = bf
    return Api


def win_ops(bf, torch, rank: int, world: int, inp) -> dict:
    """Collective plane, no control plane: the scenarios on RingGraph and
    ExponentialTwoGraph, lifecycle, the no-control-plane choices."""
    from bluefog_tpu_torch.ops import windows as W

    api = port_api(bf, torch, rank)
    out = {}
    for topo in ("ring", "expo2"):
        bf.set_topology(bf.topology_util.RingGraph(world) if topo == "ring"
                        else bf.topology_util.ExponentialTwoGraph(world))
        out.update(run_scenarios(api, inp, topo))
    out.update(lifecycle(bf, api.mk, inp["x"]))
    # without a control plane: the collective plane, a process-local host,
    # p of every rank by all-gather, no mutex, no other rank's versions
    x = api.mk(inp["x"])
    bf.win_create(x, "np")
    win = W._get_window("np")
    checks = [not win.hosted, isinstance(win.host, W._LocalWinHost)]
    bf.turn_on_win_ops_with_associated_p()
    bf.win_accumulate(x, "np", self_weight=0.25)
    out["p_all"] = bf.win_associated_p_all("np")
    bf.turn_off_win_ops_with_associated_p()
    for fn in (lambda: bf.win_put(x, "np", require_mutex=True),
               lambda: bf.win_update("np", require_mutex=True),
               lambda: bf.win_update_then_collect("np"),
               lambda: bf.win_mutex("np")):
        try:
            fn()
            checks.append(False)
        except RuntimeError as exc:
            checks.append("control plane" in str(exc))
    try:
        bf.get_win_version("np", rank=(rank + 1) % world)
        checks.append(False)
    except ValueError:
        checks.append(True)
    bf.win_free("np")
    # the int8 blend on the collective plane
    os.environ["BFT_WIN_CODEC"] = "int8"
    try:
        bf.win_create(x, "q8", zero_init=True)
    finally:
        del os.environ["BFT_WIN_CODEC"]
    bf.win_put(x, "q8")
    out["int8_blend"] = bf.win_update("q8").numpy()
    bf.win_free("q8")
    out["no_cp_checks"] = np.array(checks)
    return out


def _sleep_phase(bf, torch, rank: int, x) -> dict:
    """Ranks 2 and 3 asleep; ranks 0 and 1 finish 5 rounds of put +
    update in bounded time with exact values (zero-init slots)."""
    t = torch.from_numpy(x[rank])
    bf.win_create(t, "os.a", zero_init=True)
    if rank >= 2:
        time.sleep(SLEEP_S)
        got = bf.win_update("os.a")
        dt = 0.0
    else:
        from bluefog_tpu_torch.runtime import control_plane as cp

        t0 = time.monotonic()
        for _ in range(5):
            bf.win_put(t, "os.a")
        # the two awake ranks meet on the server, without the sleepers
        cl = cp.client()
        cl.fetch_add("os.a.ready", 1)
        while cl.get("os.a.ready") < 2:
            time.sleep(0.001)
        got = bf.win_update("os.a")
        dt = time.monotonic() - t0
    bf.barrier()
    bf.win_free("os.a")
    return {"sleep_got": got.numpy(), "sleep_dt": np.array(dt)}


def _skew_phase(bf, torch, rank: int, x) -> dict:
    """Skewed push-sum: ranks 0-1 gossip FAST_ROUNDS at full speed, ranks
    2-3 SLOW_ROUNDS with sleeps; after a barrier and a final drain the sum
    of numerators is the sum of the inputs and the sum of p is 4."""
    from bluefog_tpu_torch.runtime import control_plane as cp

    cl = cp.client()
    n = bf.size()
    bf.turn_on_win_ops_with_associated_p()
    x0 = float(x[rank, 0])
    bf.win_create(torch.tensor([x0]), "os.ps", zero_init=True)
    outs = bf.out_neighbor_ranks()
    sw = 1.0 / (len(outs) + 1)
    dw = {d: sw for d in outs}
    est = x0
    slow = rank >= 2
    for _ in range(SLOW_ROUNDS if slow else FAST_ROUNDS):
        if slow:
            time.sleep(SLOW_SLEEP_S)
        p = bf.win_associated_p("os.ps")
        bf.win_accumulate(torch.tensor([est * p]), "os.ps", self_weight=sw,
                          dst_weights=dw, require_mutex=True)
        got = bf.win_update_then_collect("os.ps")
        est = float(got[0]) / bf.win_associated_p("os.ps")
    # the fast ranks finish before any slow one did
    uncoupled = True
    if slow:
        cl.put("os.b.done", 1)
    else:
        uncoupled = cl.get("os.b.done") == 0
    bf.barrier()
    got = bf.win_update_then_collect("os.ps")
    cp.put_float(cl, f"os.b.part.{rank}", float(got[0]))
    bf.barrier()
    total = sum(cp.get_float(cl, f"os.b.part.{r}") for r in range(n))
    p_all = bf.win_associated_p_all("os.ps")
    bf.barrier()
    bf.win_free("os.ps")
    bf.turn_off_win_ops_with_associated_p()
    return {"skew_total": np.array(total), "skew_p": p_all,
            "skew_uncoupled": np.array(uncoupled)}


HAMMER_ROUNDS = 10


def _hammer_phase(bf, torch, rank: int) -> dict:
    """``tests/test_hosted_windows.py``'s concurrency tests at world 4,
    where the concurrency is the other processes': every rank alternates
    ``require_mutex`` accumulates of ones with ``require_mutex`` collects
    under ``BFT_WIN_STRICT=1``, with no barrier between, putting its row
    back after each collect; after a barrier a last collect. Every
    deposited unit is collected exactly once and the strict check never
    fires. (Threads of one process sharing its control-plane client would
    queue their calls behind a blocked lock call.)"""
    from bluefog_tpu_torch.ops import windows as W

    os.environ["BFT_WIN_STRICT"] = "1"
    x = torch.ones(2)
    bf.win_create(x, "h.hammer", zero_init=True)
    win = W._get_window("h.hammer")
    collected, ok = 0.0, True
    try:
        for _ in range(HAMMER_ROUNDS):
            bf.win_accumulate(x, "h.hammer", require_mutex=True)
            collected += float(bf.win_update_then_collect(
                "h.hammer").sum()) - 2.0
            win.self_value = x
        bf.barrier()
        collected += float(bf.win_update_then_collect("h.hammer").sum()) \
            - 2.0
    except RuntimeError:
        ok = False
    finally:
        del os.environ["BFT_WIN_STRICT"]
    bf.barrier()
    bf.win_free("h.hammer")
    return {"hammer_collected": np.array(collected),
            "hammer_expected": np.array(
                2.0 * HAMMER_ROUNDS * len(bf.in_neighbor_ranks())),
            "hammer_errors": np.array(ok)}


def _mutex_phase(bf, torch, rank: int, x) -> dict:
    """An outside client holding the window mutexes blocks a
    ``require_mutex`` put until it releases; ``win_mutex`` takes the
    server's lock so an outside client cannot."""
    from bluefog_tpu_torch.runtime import native

    host, port = os.environ["BFT_CP_HOST"], int(os.environ["BFT_CP_PORT"])
    t = torch.from_numpy(x[rank])
    bf.win_create(t, "cp.mu")
    res = {}
    if rank == 0:
        actor = native.ControlPlaneClient(host, port, rank=90, streams=1)
        try:
            for r in range(bf.size()):
                actor.lock(f"w.cp.mu.mu.{r}")
            done = threading.Event()
            th = threading.Thread(target=lambda: (bf.win_put(
                t, "cp.mu", require_mutex=True), done.set()), daemon=True)
            th.start()
            time.sleep(0.4)
            res["blocked"] = not done.is_set()
            for r in range(bf.size()):
                actor.unlock(f"w.cp.mu.mu.{r}")
            res["released"] = done.wait(10.0)
            th.join(5.0)
            got = {}

            def grab():
                actor.lock("w.cp.mu.mu.1")
                got["locked"] = True
                actor.unlock("w.cp.mu.mu.1")

            with bf.win_mutex("cp.mu", ranks=[1]):
                th = threading.Thread(target=grab, daemon=True)
                th.start()
                th.join(0.4)
                res["excluded"] = "locked" not in got
            th.join(10.0)
            res["regained"] = bool(got.get("locked"))
        finally:
            actor.close()
    bf.barrier()
    bf.win_free("cp.mu")
    return {f"mutex_{k}": np.array(v) for k, v in res.items()}


def win_hosted(bf, torch, rank: int, world: int, inp) -> dict:
    """A control plane of 4 (the parent serves): the default plane is the
    hosted one. The scenarios on ExponentialTwoGraph, the metrics, the
    mutex exclusion, two ranks asleep, a skewed push-sum; then the
    collective plane WITH the control plane (scalars on the server)."""
    from bluefog_tpu_torch.ops import windows as W
    from bluefog_tpu_torch.runtime import metrics
    from bluefog_tpu_torch.runtime.state import _global_state

    api = port_api(bf, torch, rank)
    api.hosted[0] = True

    def all_versions(name):
        return np.stack([np.array([v for _, v in sorted(
            bf.get_win_version(name, rank=r).items())], np.int64)
            for r in range(world)])

    out = {}
    x = api.mk(inp["x"])
    bf.win_create(x, "h.sel")
    win = W._get_window("h.sel")
    h_put = metrics.histogram("win.put_sec").count
    h_upd = metrics.histogram("win.update_sec").count
    drained = metrics.snapshot()["counters"].get("win.deposits_drained", 0)
    bf.win_put(x, "h.sel")
    bf.barrier()
    bf.win_update("h.sel")
    snap = metrics.snapshot()["counters"]
    out["hosted_checks"] = np.array([
        win.hosted, win.owned == [rank],
        isinstance(win.host, W._ControlPlaneWinHost),
        metrics.histogram("win.put_sec").count == h_put + 1,
        metrics.histogram("win.update_sec").count == h_upd + 1,
        snap.get("win.deposits_drained", 0) - drained
        == len(bf.in_neighbor_ranks()),
        snap.get("win.deposits_sent", 0) >= len(bf.out_neighbor_ranks())])
    bf.win_free("h.sel")
    # the scenarios: versions of every rank read through the server
    api.versions = all_versions
    bf.set_topology(bf.topology_util.ExponentialTwoGraph(world))
    out.update(run_scenarios(api, inp, "hosted", mutex=True))
    bf.barrier()
    out.update(_hammer_phase(bf, torch, rank))
    out.update(_mutex_phase(bf, torch, rank, inp["x"]))
    bf.set_topology(bf.topology_util.RingGraph(world))
    out.update(_sleep_phase(bf, torch, rank, inp["ring_x"]))
    out.update(_skew_phase(bf, torch, rank, inp["ring_x"]))
    # the collective plane with the control plane attached
    os.environ["BFT_WIN_PLANE"] = "compiled"
    st = _global_state()
    st.win_plane = W._plane_policy()
    bf.set_topology(bf.topology_util.ExponentialTwoGraph(world))
    out.update(run_scenarios(api, inp, "cpcoll", mutex=True))
    bf.win_create(x, "cc")
    out["cpcoll_backend"] = np.array([
        not W._get_window("cc").hosted,
        isinstance(W._get_window("cc").host, W._ControlPlaneWinHost)])
    bf.win_free("cc")
    return out
