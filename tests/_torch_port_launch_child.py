"""One rank of a job the port's launcher starts (``tests/test_torch_port_launcher_launch.py``).

    python -m bluefog_tpu_torch.launcher ... -- python _torch_port_launch_child.py MODE [--device cpu]

The rank joins the job through the environment the launcher gave it
(``bf.init()``: ``torchrun``'s variables, and the CPU under ``--simulate``),
runs ``MODE`` and prints its markers, each with its rank; the port's
counterparts of the JAX package's multi-controller children
(``tests/_launch_child.py``, ``_quad_child.py``, ``_quad_fault_child.py``,
``_fault_child.py``, ``_topocheck_child.py``, ``_onesided_child.py``).
Under a world of more than one rank the control plane is attached
(``MASTER_PORT + 17``), so windows are hosted and every process is a
controller with a heartbeat. It imports the port only, never JAX.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch.runtime import control_plane as cp


def _say(marker: str) -> None:
    print(f"{marker} {bf.rank()}", flush=True)


def smoke() -> None:
    """Size, rank and local layout as the launcher set them; a collective,
    the neighbour combine's closed form and a control-plane counter."""
    n, r = bf.size(), bf.rank()
    assert n == int(os.environ["WORLD_SIZE"]), n
    assert r == int(os.environ["RANK"]), r
    assert bf.local_rank() == int(os.environ.get("LOCAL_RANK", r))
    assert bf.local_size() == int(os.environ.get("LOCAL_WORLD_SIZE", n))
    assert cp.active() and cp.world() == n
    total = bf.allreduce(torch.full((3,), float(r + 1)), average=False)
    assert torch.equal(total, torch.full((3,), n * (n + 1) / 2.0)), total
    bf.set_topology(bf.topology_util.RingGraph(n))
    got = bf.neighbor_allreduce(torch.full((2,), float(r)))
    nbrs = bf.in_neighbor_ranks()
    want = (r + sum(nbrs)) / (len(nbrs) + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    cp.client().fetch_add("launch.smoke", 1)
    bf.barrier()
    assert cp.client().get("launch.smoke") == n
    _say("CHILD_OK")


def quad() -> None:
    """The four-controller job of ``tests/_quad_child.py``: hosted windows
    with exact values (A), mutex-guarded accumulates with their mass
    conserved (B), the topology check agreeing and catching a four-way
    divergence (D), and ``win_fence`` making one controller's deposits
    visible (E)."""
    n, r = bf.size(), bf.rank()
    assert n == 4, n
    assert len(os.environ.get("BFT_CP_SECRET", "")) == 32
    x = torch.full((1,), float(r + 1))
    in_nbrs, out_nbrs = bf.in_neighbor_ranks(), bf.out_neighbor_ranks()
    u = 1.0 / (len(in_nbrs) + 1)

    # A: put then accumulate, so each slot holds 2 x[src]
    assert bf.win_create(x, "q.a", zero_init=True)
    bf.win_put(x, "q.a")
    bf.win_accumulate(x, "q.a")
    bf.barrier()
    got = bf.win_update("q.a")
    want = u * ((r + 1) + sum(2.0 * (s + 1) for s in in_nbrs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    _say("PHASE_A_OK")
    bf.barrier()
    bf.win_free("q.a")

    # B: contended mutexes; the neighbour mass every rank collects
    assert bf.win_create(x, "q.mu", zero_init=True)
    rounds = 6
    for _ in range(rounds):
        bf.win_accumulate(x, "q.mu", require_mutex=True)
    bf.win_fence("q.mu")
    part = bf.win_update_then_collect("q.mu") - x
    total = float(bf.allreduce(part, average=False)[0])
    want = rounds * sum((s + 1) * len(bf.out_neighbor_ranks(s))
                        for s in range(n))
    assert abs(total - want) < 1e-3, (total, want)
    if r == 0:
        print(f"PHASE_B_MASS {total:.1f}", flush=True)
    bf.barrier()
    bf.win_free("q.mu")

    # D: the cross-controller topology check, agreed then divergent
    sw = {q: 0.5 for q in range(n)}
    y = bf.neighbor_allreduce(
        x, self_weight=sw,
        neighbor_weights={q: {(q - 1) % n: 0.5} for q in range(n)},
        send_neighbors={q: [(q + 1) % n] for q in range(n)})
    np.testing.assert_allclose(y.numpy(), 0.5 * (r + 1) + 0.5 * (
        (r - 1) % n + 1), atol=1e-6)
    _say("PHASE_D_AGREED")
    bf.barrier()
    w = 0.1 * (r + 1)                  # every controller other weights
    try:
        bf.neighbor_allreduce(
            x, self_weight={q: 1.0 - w for q in range(n)},
            neighbor_weights={q: {(q - 2) % n: w} for q in range(n)},
            send_neighbors={q: [(q + 2) % n] for q in range(n)},
            name="divergent")
        raise AssertionError("divergent edge sets were not detected")
    except RuntimeError as exc:
        assert "DIFFERENT dynamic edge sets" in str(exc), exc
    _say("PHASE_D_DIVERGENT_RAISED")
    bf.barrier()

    # E: only controller 1 writes this epoch; the fence folds its deposits
    assert bf.win_create(torch.zeros(1), "q.f", zero_init=True)
    if r == 1:
        bf.win_put(x, "q.f")
    assert bf.win_fence("q.f")
    got = bf.win_update("q.f", clone=True)
    self_term = float(r + 1) if r == 1 else 0.0
    want = u * (self_term + (2.0 if 1 in in_nbrs else 0.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    _say("PHASE_E_FENCE_OK")
    bf.barrier()
    bf.win_free("q.f")
    assert set(out_nbrs) and set(in_nbrs)
    _say("CHILD_OK")


def fault() -> None:
    """``tests/_quad_fault_child.py``: the last rank dies silently (exit
    17); every survivor's heartbeat names it dead, and a collective that
    needs it raises ``PeerLostError`` naming it within its deadline."""
    n, r = bf.size(), bf.rank()
    victim = n - 1
    bf.allreduce(torch.ones(2))
    bf.barrier()
    _say("HEALTHY")
    if r == victim:
        os._exit(17)                   # silent: no announce, no atexit
    deadline = time.monotonic() + 30
    while bf.dead_controllers() != {victim}:
        assert not bf.shutdown_requested(), \
            "a crash must be a dead peer, not a coordinated shutdown"
        if time.monotonic() > deadline:
            _say("SURVIVOR_TIMEOUT")
            os._exit(3)
        time.sleep(0.05)
    _say("SURVIVOR_DETECTED")
    result = {}

    def doomed():
        try:
            h = bf.allreduce_nonblocking(torch.ones(2), name="doomed")
            bf.synchronize(h, timeout=5.0)
            result["outcome"] = "completed"
        except bf.PeerLostError as exc:
            result["outcome"] = "raised" if victim in exc.dead else str(exc)

    t = threading.Thread(target=doomed, daemon=True)
    t.start()
    t.join(20)
    if result.get("outcome") == "raised":
        _say("SURVIVOR_SYNC_RAISED")
    sys.stdout.flush()
    os._exit(0)                        # the process group is broken


def topo() -> None:
    """``tests/_topocheck_child.py``: every controller's dynamic edge set
    agreeing passes the check with the closed form; each controller's own
    weights raise on every controller (``BFT_TOPO_CHECK_TIMEOUT``)."""
    n, r = bf.size(), bf.rank()
    x = torch.full((1,), float(r + 1))
    y = bf.neighbor_allreduce(
        x, self_weight={q: 0.5 for q in range(n)},
        neighbor_weights={q: {(q - 1) % n: 0.5} for q in range(n)},
        send_neighbors={q: [(q + 1) % n] for q in range(n)})
    np.testing.assert_allclose(y.numpy(), 0.5 * (r + 1) + 0.5 * (
        (r - 1) % n + 1), atol=1e-6)
    _say("AGREED_OK")
    bf.barrier()
    w = 0.1 * (r + 1)
    try:
        bf.neighbor_allreduce(
            x, self_weight={q: 1.0 - w for q in range(n)},
            neighbor_weights={q: {(q - 1) % n: w} for q in range(n)},
            send_neighbors={q: [(q + 1) % n] for q in range(n)},
            name="divergent")
        raise AssertionError("divergent edge sets were not detected")
    except RuntimeError as exc:
        assert "DIFFERENT dynamic edge sets" in str(exc), exc
    _say("DIVERGENT_RAISED")
    bf.barrier()
    _say("CHILD_OK")


def onesided() -> None:
    """``tests/_onesided_child.py`` at world 2, phase A: rank 1 sleeps in
    its step while rank 0's ``win_put`` and ``win_update`` complete in
    bounded time."""
    r = bf.rank()
    x = torch.full((4,), float(r + 1))
    assert bf.win_create(x, "o.a", zero_init=True)
    bf.barrier()
    if r == 1:
        time.sleep(3.0)
    else:
        t0 = time.monotonic()
        bf.win_put(x, "o.a")
        bf.win_update("o.a")
        took = time.monotonic() - t0
        assert took < 2.5, took
        print("PHASE_A_BOUNDED", flush=True)
    bf.barrier()
    bf.win_free("o.a")
    _say("CHILD_OK")


MODES = {"smoke": smoke, "quad": quad, "fault": fault, "topo": topo,
         "onesided": onesided}


def main() -> None:
    mode = sys.argv[1]
    device = sys.argv[3] if sys.argv[2:3] == ["--device"] else None
    torch.set_num_threads(1)
    bf.init(device=device)
    MODES[mode]()
    bf.shutdown()


if __name__ == "__main__":
    main()
