"""Failure detection across processes: world-4 gloo jobs under a control
plane this test process serves (``tests/_torch_port_child.py``).

Each test has a FileStore (its ``tmp_path``) and a control-plane server of
its own on a free port, so the files run side by side under xdist; every
process wait in ``run_world`` has its own timeout.

* ``peer_lost``: rank 3 is SIGKILLed where the others issue
  ``allreduce_nonblocking``. Every survivor's ``synchronize(timeout)``
  raises ``PeerLostError`` with ``.dead == {3}``, ``dead_ranks()`` and
  ``dead_controllers()`` agree, the membership epoch rose, and a
  ``fatal`` flight dump was left; the heartbeat's timeout bounds how long
  that takes.
* ``topo_check``: the same dynamic ``send_neighbors`` agree across the
  controllers (and the exchange gives the closed form); one controller's
  different set makes every controller's check raise within
  ``BFT_TOPO_CHECK_TIMEOUT``; a controller one step ahead in a cyclic
  schedule is caught at the re-arm, as
  ``tests/test_control_plane.py::test_topo_check_rearm_catches_desynced_schedule``
  catches it, and the next re-arm in step agrees.
* ``sidecar_epoch``: the checkpoint sidecar carries the membership epoch
  (four attaches under ``BFT_INCARNATION=1`` raise it to at least 4).
"""

import numpy as np
import pytest

from bluefog_tpu_torch.runtime import native

from _torch_port_child import run_world

WORLD = 4


@pytest.fixture()
def cp_world(tmp_path, monkeypatch):
    """A control-plane server for a world of 4 and the children's env."""
    srv = native.ControlPlaneServer(WORLD, 0)

    def env(**extra):
        for k, v in {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(srv.port),
                     "BFT_CP_SERVE": "0", "BFT_CP_CONNECT_TIMEOUT": "60",
                     "BFT_FLIGHT_DIR": str(tmp_path), **extra}.items():
            monkeypatch.setenv(k, str(v))
    yield srv, env
    srv.stop()


def test_world4_peer_lost_on_every_survivor(tmp_path, cp_world):
    srv, env = cp_world
    # a 3 s timeout: a survivor starved on a loaded host is not taken for
    # dead
    env(BFT_HEARTBEAT_INTERVAL=0.25, BFT_HEARTBEAT_TIMEOUT=3,
        BFT_FLIGHT_MIN_INTERVAL=0)
    np.savez(tmp_path / "inputs.npz", victim=3, sync_timeout=15.0)
    outs = run_world("peer_lost", str(tmp_path), WORLD, timeout=120,
                     killed=(3,))
    assert outs[3] is None
    for r in range(3):
        out = outs[r]
        assert out["dead"].tolist() == [3], (r, str(out["message"]))
        assert out["dead_ranks"].tolist() == [3]
        assert out["dead_controllers"].tolist() == [3]
        assert bool(out["epoch_rose"])
        assert bool(out["dump"]), r
        assert "DEAD" in str(out["message"])
        # detection needs the heartbeat's 3 s silence; the deadline is 15
        assert float(out["seconds"]) < 15.5, r


def test_world4_topology_check_agrees_diverges_and_rearms(tmp_path,
                                                         cp_world):
    srv, env = cp_world
    env(BFT_TOPO_CHECK_TIMEOUT=2, BFT_TOPO_CHECK_REARM=4)
    np.savez(tmp_path / "inputs.npz", unused=0)
    outs = run_world("topo_check", str(tmp_path), WORLD, timeout=120)
    for r, out in enumerate(outs):
        want = 0.5 * r + 0.5 * ((r - 1) % WORLD)
        np.testing.assert_array_equal(out["agreed"], [want, want])
        np.testing.assert_array_equal(out["warm"], [want, want])
        # every controller's check refused the divergent step at its
        # timeout, and nothing was exchanged: the ring stayed in step
        assert 2.0 <= float(out["diverged_s"]) < 10.0, r
        assert float(out["rearm_s"]) < 10.0, r
        for c, shift in ((5, 1), (6, 2), (7, 1), (8, 2)):
            want = 0.5 * r + 0.5 * ((r - shift) % WORLD)
            np.testing.assert_array_equal(out[f"c{c}"], [want, want])
        # two re-arm rounds of four tickets each, on one fixed key per
        # controller
        assert int(out["tickets"]) == 8
    p = native.ControlPlaneClient("127.0.0.1", srv.port, 100, streams=1)
    try:
        assert all(p.get(f"tc.rearm.{r}") for r in range(WORLD))
    finally:
        p.close()


def test_world4_checkpoint_sidecar_carries_membership_epoch(tmp_path,
                                                           cp_world):
    srv, env = cp_world
    env(BFT_INCARNATION=1, BFT_HEARTBEAT_INTERVAL=0.1)
    np.savez(tmp_path / "inputs.npz", unused=0)
    outs = run_world("sidecar_epoch", str(tmp_path), WORLD, timeout=120)
    assert int(outs[0]["meta_epoch"]) == int(outs[0]["epoch"])
    # four attaches registered an incarnation with the server, each
    # bumping the epoch the heartbeats mirror
    assert all(int(out["epoch"]) >= WORLD for out in outs)
