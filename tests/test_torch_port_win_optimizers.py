"""Port vs JAX: the window optimizers (win-put, pull-get, push-sum).

**In process.** The healing helpers (``_live_neighbor_sets``,
``_healed_recv_weights``, ``_healed_send_table``) against JAX's on
seeded topologies, dead sets, demoted edges and custom weights: the dict
tables compared exactly; ``tests/test_tuner.py``'s ``test_healed_tables_*``.
At world 1 on a control plane of one (``BFT_WIN_PLANE=hosted``):
``step_report()`` splits a window step into local, pack, gossip and unpack;
a raw row above the server's message ceiling (or a raw deposit above the
mailbox cap) is refused at construction, naming ``BFT_WIN_SHARD`` and
``BFT_WIN_CODEC``, before anything is published; push-sum's ``free()``
restores the associated-p flag; the rotation realigns from an adopted
counter and a sharded transfer never mixes donors
(``tests/test_sharded_windows.py:474-527``).

**World 4** (gloo processes, ``tests/_torch_port_winopt_child.py``) on
``ExponentialTwoGraph(4)``, against JAX's 4-device run of the same configs
(the same numpy inputs from a seed; SGD 0.1 on a quadratic loss, or a zero
loss where only the gossip moves the values):

* the collective plane (no control plane, the default ``require_mutex``):
  all three kinds, fused and per-parameter windows,
  ``num_steps_per_communication=2``, bf16, sharded S=2 and S=3 win-put and
  S=2 push-sum; f32 to 1e-6, bf16 to one bf16 ulp of the largest value, p
  and ``sum(p)`` exactly; the sharded runs reach consensus and push-sum
  its exact mean (``tests/test_sharded_windows.py:251-270``);
* the hosted plane (a control plane of 4 the test serves), in lockstep
  (a barrier before each one-sided write and each combine): the same
  configs against the same JAX results; int8 and top-k deposits from
  replicated initial parameters against JAX's hosted run (one controller
  holding the 4 ranks), with ``ef_residual_norm``; the
  consensus gauge against its numpy oracle each step and push-sum without
  it (``tests/test_timeseries.py``); unsynchronized steps under the
  default mutex; the rejoins of a respawned rank 0: win-put adopts donor
  2's row and step counter, push-sum's mass split is bit-exact
  (``tests/test_chaos.py:1176``), a sharded transfer collects both shards
  from one donor, the checkpoint fallback re-mints p = 1;
* a SIGKILLed rank 3: after the detector names it, the survivors' steps
  equal JAX's oracle on the healed graph (its hosted run with
  ``dead_ranks`` = {3} from the same step), one healed rebuild, no retry.
"""

import os
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import bluefog_tpu as jbf
import bluefog_tpu_torch as bft
from bluefog_tpu import optimizers as JO
from bluefog_tpu.ops import windows as JW
from bluefog_tpu.runtime import control_plane as jcp
from bluefog_tpu.runtime import heartbeat as jhb
from bluefog_tpu_torch import optimizers as PO
from bluefog_tpu_torch.ops import windows as W
from bluefog_tpu_torch.runtime import control_plane as cp
from bluefog_tpu_torch.runtime import native
from bluefog_tpu_torch.runtime.native import ControlPlaneClient
from conftest import cpu_devices
from _torch_port_child import run_world
from _torch_port_winopt_child import (AFTER_KILL, CODEC_CONFIGS, CONFIGS,
                                      CONSENSUS_STEPS, DONOR, HOSTED,
                                      KILL_AT, LR, N, REJOIN_STEPS, VICTIM,
                                      clear_knobs, inputs, set_knobs)

TOL = 1e-6


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# the healing helpers, in process
# ---------------------------------------------------------------------------

class _Win:
    """What the healing helpers read of a window: size and every rank's
    neighbours."""

    def __init__(self, topo, n):
        self.size = n
        self.in_neighbors = {r: jbf.topology_util.in_neighbor_ranks(topo, r)
                             for r in range(n)}
        self.out_neighbors = {
            r: jbf.topology_util.out_neighbor_ranks(topo, r)
            for r in range(n)}


def _topos():
    tu = jbf.topology_util
    return {"expo2_8": (tu.ExponentialTwoGraph(8), 8),
            "ring_5": (tu.RingGraph(5), 5),
            "mesh_6": (tu.MeshGrid2DGraph(6), 6),
            "star_4": (tu.StarGraph(4), 4)}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("topo", list(_topos()))
def test_healed_tables_equal_jax(topo, seed):
    g, n = _topos()[topo]
    win = _Win(g, n)
    rng = np.random.default_rng(seed)
    dead = set(int(r) for r in rng.choice(n, size=int(rng.integers(0, 3)),
                                          replace=False))
    edges = [(s, d) for d in range(n) for s in win.in_neighbors[d]]
    pick = rng.choice(len(edges), size=min(2, len(edges)), replace=False)
    demoted = frozenset(edges[int(i)] for i in pick)
    sw = {r: float(rng.uniform(0.2, 0.6)) for r in range(n)}
    nw = {r: {s: float(rng.uniform(0.1, 0.4)) for s in win.in_neighbors[r]}
          for r in range(n)}
    dw = {r: {d: float(rng.uniform(0.5, 2.0)) for d in win.out_neighbors[r]}
          for r in range(n)}
    for dd, dm in ((dead, frozenset()), (set(), demoted), (dead, demoted)):
        assert PO._live_neighbor_sets(win, dd, dm) == \
            JO._live_neighbor_sets(win, dd, dm)
        for args in ((None, None), (0.5, None), (sw, nw), (0.3, nw)):
            if args[1] is None and args[0] is not None:
                continue
            assert PO._healed_recv_weights(win, dd, *args, dm) == \
                JO._healed_recv_weights(win, dd, *args, dm)
        for d in (None, dw):
            assert PO._healed_send_table(win, dd, d, dm) == \
                JO._healed_send_table(win, dd, d, dm)


def test_healed_tables_treat_demoted_edges_like_dead_for_that_column():
    """``tests/test_tuner.py``'s case: a demoted edge drops from the
    receiver's column (renormalized) and from the sender's table; other
    columns never move; demotion composes with a dead set."""

    class _Ring:
        size = 4
        out_neighbors = {0: [1], 1: [2], 2: [3], 3: [0]}
        in_neighbors = {0: [3], 1: [0], 2: [1], 3: [2]}

    win = _Ring()
    demoted = frozenset({(2, 3)})
    sw, nw = PO._healed_recv_weights(win, set(), None, None, demoted)
    assert nw[3] == {} and sw[3] == 1.0
    assert nw[1] == {0: 0.5} and sw[1] == 0.5
    send = PO._healed_send_table(win, set(), None, demoted)
    assert send[2] == {} and send[1] == {2: 1.0}
    nbr_w = {r: {p: 0.5 for p in win.in_neighbors[r]} for r in range(4)}
    sw2, nw2 = PO._healed_recv_weights(win, set(), 0.5, nbr_w, demoted)
    assert sw2[3] == pytest.approx(1.0) and nw2[3] == {}
    assert sw2[1] == pytest.approx(0.5)
    assert nw2[1] == {0: pytest.approx(0.5)}
    sw3, nw3 = PO._healed_recv_weights(win, {0}, None, None, demoted)
    assert nw3[1] == {} and nw3[3] == {}
    assert (sw3, nw3) == JO._healed_recv_weights(win, {0}, None, None,
                                                 demoted)


# ---------------------------------------------------------------------------
# world 1 on a control plane of one, in process
# ---------------------------------------------------------------------------

@pytest.fixture()
def hosted1(monkeypatch, tmp_path):
    for k, v in {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(_free_port()),
                 "BFT_WIN_PLANE": "hosted", "BFT_FLIGHT_DIR": str(tmp_path),
                 "BFT_CYCLE_TIME": "600000"}.items():
        monkeypatch.setenv(k, v)
    bft.init(device="cpu")
    assert cp.active()
    yield bft
    bft.shutdown()


def _small(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 3))


def _sq_loss(m, x):
    return (m(x) ** 2).mean()


@pytest.mark.parametrize("cls", ["DistributedWinPutOptimizer",
                                 "DistributedPushSumOptimizer"])
def test_step_report_splits_a_window_step(hosted1, cls):
    model = _small()
    opt = getattr(bft, cls)(torch.optim.SGD(model.parameters(), lr=0.1),
                            model, _sq_loss)
    x = torch.ones(4, 8)
    for _ in range(3):
        opt.step(x)
    rep = bft.step_report()
    opt.free()
    assert rep is not None and rep["step"] == 3
    for phase in ("local", "pack", "unpack"):
        assert rep["phases"].get(phase, 0.0) > 0.0, (phase, rep["phases"])
    assert rep["gossip_sec"] > 0.0
    assert sum(rep["phases"].values()) <= rep["step_sec"]


def test_hosted_row_above_the_ceiling_is_refused_naming_the_knobs(
        hosted1, monkeypatch):
    """A raw row the server cannot take (here the ceiling is lowered to
    1 KiB: 99 f32 parameters are 396 bytes, 8x16+16+16x3+3 = 195 more) is
    refused at construction, before any window exists; a shard factor or a
    codec makes it fit."""
    monkeypatch.setattr(ControlPlaneClient, "_MAX_PAYLOAD", 600)
    model = _small()
    with pytest.raises(ValueError, match="BFT_WIN_SHARD") as exc:
        bft.DistributedWinPutOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), model, _sq_loss)
    assert "BFT_WIN_CODEC" in str(exc.value)
    from bluefog_tpu_torch.runtime.state import _global_state

    assert _global_state().windows == {}
    for knob, val in (("BFT_WIN_SHARD", "2"), ("BFT_WIN_CODEC", "int8")):
        monkeypatch.setenv(knob, val)
        opt = bft.DistributedWinPutOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), model, _sq_loss)
        opt.step(torch.ones(2, 8))
        opt.free()
        monkeypatch.delenv(knob)


def test_hosted_raw_deposit_above_the_mailbox_cap_is_refused(monkeypatch):
    monkeypatch.setattr(cp, "mailbox_cap_bytes", lambda: 100)
    monkeypatch.setattr(W, "_hosted_mode_enabled", lambda policy=None: True)
    bft.init(device="cpu", topology_fn=lambda n: bft.topology_util
             .FullyConnectedGraph(n))
    try:
        opt = PO.DistributedWinPutOptimizer.__new__(
            PO.DistributedWinPutOptimizer)
        opt.name = "probe"
        model = _small()
        from bluefog_tpu_torch.ops import fusion

        spec = fusion.make_spec(list(model.parameters()))
        # a world of one has no out-neighbour: no deposit, nothing refused
        opt._check_row_fits(spec)
        monkeypatch.setattr(bft.topology_util, "out_neighbor_ranks",
                            lambda topo, r: [1])
        with pytest.raises(ValueError, match="BFT_CP_MAILBOX_MAX_MB"):
            opt._check_row_fits(spec)
    finally:
        bft.shutdown()


def test_pushsum_free_restores_the_associated_p_flag(hosted1):
    from bluefog_tpu_torch.runtime.state import _global_state

    st = _global_state()
    assert st.win_ops_with_associated_p is False
    model = _small()
    opt = bft.DistributedPushSumOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), model, _sq_loss)
    assert st.win_ops_with_associated_p is True
    assert opt.ef_residual_norm() == 0.0
    opt.step(torch.ones(2, 8))
    opt.free()
    assert st.win_ops_with_associated_p is False
    assert opt._win_names == []


def test_rejoin_realigns_rotation_with_stepping_peers(hosted1):
    model = _small()
    mk = lambda: bft.DistributedWinPutOptimizer(  # noqa: E731
        torch.optim.SGD(model.parameters(), lr=0.1), model, _sq_loss,
        num_steps_per_communication=3)
    peer = mk()
    peer._shard_factor = 4
    for c in (1, 2, 3, 7, 21, 22):
        peer._counter, peer._comm_rounds = c, c // 3
        rejoiner = mk()
        rejoiner._shard_factor = 4
        rejoiner._counter = c
        assert rejoiner._comm_rounds == 0
        rejoiner._realign_rotation()
        assert rejoiner._comm_rounds == peer._comm_rounds
        assert rejoiner._active_shard() == peer._active_shard()
        rejoiner.free()
    peer.free()


def test_sharded_transfer_does_not_mix_donors(hosted1, monkeypatch):
    import contextlib
    import time

    model = _small()
    opt = bft.DistributedWinPutOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), model, _sq_loss)
    names = opt._win_names
    opt._shard_factor = 2
    opt._win_names = ["sx.fake"]
    opt._rejoin_shards[("sx.fake", 0)] = {0: np.zeros(3, np.float32)}

    class _Stalled:
        def read_published_shard(self, donor):
            return np.ones(3, np.float32), 1

    monkeypatch.setattr(W, "_get_window", lambda nm: _Stalled())
    monkeypatch.setattr(W, "win_mutex",
                        lambda nm, ranks=None: contextlib.nullcontext())
    ok = opt._transfer_rank_sharded(0, 1, deadline=time.monotonic() + 0.3)
    assert not ok
    assert 0 not in opt._rejoin_shards[("sx.fake", 0)]
    monkeypatch.undo()
    opt._win_names = names
    opt.free()


# ---------------------------------------------------------------------------
# JAX's side of the world-4 configs
# ---------------------------------------------------------------------------

_JCLS = {"put": jbf.DistributedWinPutOptimizer,
         "get": jbf.DistributedPullGetOptimizer,
         "pushsum": jbf.DistributedPushSumOptimizer}


def _jloss(kind):
    if kind == "zero":
        return lambda p, t: 0.0 * (jnp.sum(p["w"]) + jnp.sum(p["b"]))
    return lambda p, t: (0.5 * jnp.sum((p["w"] - t[:24].reshape(6, 4)) ** 2)
                         + 0.5 * jnp.sum((p["b"] - t[24:]) ** 2))


def jax_config(name, cfg, inp, dead_from=None, dead=frozenset(),
               replicated=False):
    """One config on JAX's initialized runtime: ``(w, b, p or None, ef)``,
    rank-stacked; ``dead`` is what ``dead_ranks()`` says from step
    ``dead_from`` (1-based) on; ``replicated``: every rank starts from
    rank 0's parameters."""
    kind, knobs, k, dtype, loss, steps = cfg
    dt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    b0, w0 = inp["b"], inp["w"]
    if replicated:
        b0, w0 = np.broadcast_to(b0[:1], b0.shape), \
            np.broadcast_to(w0[:1], w0.shape)
    params0 = {"b": jnp.asarray(b0, dt), "w": jnp.asarray(w0, dt)}
    set_knobs("BLUEFOG_", knobs)
    try:
        opt = _JCLS[kind](optax.sgd(LR), _jloss(loss),
                          num_steps_per_communication=k,
                          window_prefix="j." + name)
        st0 = opt.init(jax.tree_util.tree_map(lambda x: x[0], params0))
    finally:
        clear_knobs("BLUEFOG_", knobs)
    mesh = jbf.mesh()
    state = jbf.TrainState(
        params=jax.device_put(params0, jbf.rank_sharding(mesh)),
        opt_state=st0.opt_state, model_state=None)
    batch = jbf.shard_rank_stacked(mesh, jnp.asarray(inp["t"]))
    real = jhb.dead_ranks
    try:
        for i in range(1, steps + 1):
            if dead_from is not None and i >= dead_from:
                jhb.dead_ranks = lambda: set(dead)
            state, _ = opt.step(state, batch)
    finally:
        jhb.dead_ranks = real
    p = None
    if kind == "pushsum":
        p = np.asarray(JW.win_associated_p_all(opt._win_names[0]))
    ef = opt.ef_residual_norm()
    w = np.asarray(state.params["w"].astype(jnp.float32))
    b = np.asarray(state.params["b"].astype(jnp.float32))
    opt.free()
    return w, b, p, ef


def _jax_collective(inp):
    jbf.init(devices=cpu_devices(N))
    try:
        return {name: jax_config(name, cfg, inp)
                for name, cfg in CONFIGS.items()}
    finally:
        jbf.shutdown()


def _jax_hosted(inp, configs, **kw):
    """JAX's hosted plane, one controller holding the 4 ranks."""
    env = {"BLUEFOG_CP_HOST": "127.0.0.1",
           "BLUEFOG_CP_PORT": str(_free_port()), "BLUEFOG_CP_WORLD": "1",
           "BLUEFOG_CP_RANK": "0", "BLUEFOG_WIN_PLANE": "hosted"}
    os.environ.update(env)
    jcp.reset_for_test()
    jbf.init(devices=cpu_devices(N))
    try:
        assert jcp.active()
        return {name: jax_config(name, cfg, inp, **kw)
                for name, cfg in configs.items()}
    finally:
        jbf.shutdown()
        jcp.reset_for_test()
        for k in env:
            del os.environ[k]


def _close(got, want, key, dtype="f32"):
    if dtype == "bf16":
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp, err_msg=key)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=key)


def _check(port, jx, name, key=None, ranks=range(N)):
    cfg = CONFIGS.get(name) or CODEC_CONFIGS[name]
    key = key or name
    w, b, p, _ = jx[name]
    for r in ranks:
        _close(port[r][f"{key}.w"], w[r], f"{key}.w rank {r}", cfg[3])
        _close(port[r][f"{key}.b"], b[r], f"{key}.b rank {r}", cfg[3])
    if p is not None:
        got = np.array([float(port[r][f"{key}.p"]) for r in ranks])
        np.testing.assert_array_equal(got, p[list(ranks)], err_msg=key)
        assert float(got.sum()) == float(p[list(ranks)].sum())


# ---------------------------------------------------------------------------
# world 4: the collective plane
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("winopt_coll")
    inp = inputs()
    np.savez(tmp / "inputs.npz", **inp)
    mp = pytest.MonkeyPatch()
    for k in ("BFT_CP_HOST", "BFT_CP_PORT", "BFT_WIN_PLANE"):
        mp.delenv(k, raising=False)
    mp.setenv("BFT_FLIGHT_DIR", str(tmp))
    try:
        port = run_world("winopt_coll", str(tmp), N, timeout=240)
    finally:
        mp.undo()
    return port, _jax_collective(inp), inp


@pytest.mark.parametrize("name", list(CONFIGS))
def test_collective_plane_matches_jax(coll, name):
    port, jx, _ = coll
    _check(port, jx, name)


def test_collective_plane_takes_no_mutex_without_a_control_plane(coll):
    """The default ``require_mutex=True`` at world 4 without a control
    plane: the window is on the collective plane, the gossip takes no
    hoisted acquisition and its ops no mutex (there is none to take); the
    configs above ran with it."""
    port, _, _ = coll
    for r in range(N):
        assert port[r]["coll_mutex"].tolist() == [True, False, False, True]


@pytest.mark.parametrize("name", ["put_s2", "put_s3"])
def test_sharded_rotation_reaches_consensus(coll, name):
    port, _, _ = coll
    for leaf in ("w", "b"):
        stack = np.stack([port[r][f"{name}.{leaf}"] for r in range(N)])
        spread = np.abs(stack - stack.mean(axis=0)).max()
        assert spread < 5e-2, (name, leaf, spread)


def test_sharded_push_sum_reaches_the_exact_mean(coll):
    port, _, inp = coll
    for leaf in ("w", "b"):
        want = inp[leaf].astype(np.float64).mean(axis=0)
        for r in range(N):
            np.testing.assert_allclose(port[r][f"ps_s2.{leaf}"], want,
                                       atol=2e-2)


# ---------------------------------------------------------------------------
# world 4: the hosted plane
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hosted(coll, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("winopt_hosted")
    _, jx, inp = coll
    np.savez(tmp / "inputs.npz", **inp)
    srv = native.ControlPlaneServer(N, 0)
    mp = pytest.MonkeyPatch()
    try:
        for k, v in {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(srv.port),
                     "BFT_CP_SERVE": "0", "BFT_CP_CONNECT_TIMEOUT": "60",
                     "BFT_HEARTBEAT_INTERVAL": "0.2",
                     "BFT_FLIGHT_DIR": str(tmp)}.items():
            mp.setenv(k, v)
        mp.delenv("BFT_WIN_PLANE", raising=False)
        port = run_world("winopt_hosted", str(tmp), N, timeout=240)
    finally:
        mp.undo()
        srv.stop()
    return port, jx, _jax_hosted(inp, CODEC_CONFIGS, replicated=True), inp


@pytest.mark.parametrize("name", HOSTED)
def test_hosted_plane_in_lockstep_matches_jax(hosted, name):
    port, jx, _, _ = hosted
    assert port[0]["hosted_mutex"].tolist() == [True, True]
    _check(port, jx, name, key="h." + name)


@pytest.mark.parametrize("name", list(CODEC_CONFIGS))
def test_hosted_codecs_match_jax_with_ef_residual(hosted, name):
    port, _, jh, _ = hosted
    _check(port, jh, name)
    ef = np.sqrt(sum(float(port[r][f"{name}.ef"]) ** 2 for r in range(N)))
    want = jh[name][3]
    if name == "put_topk":
        assert want > 0.0
    np.testing.assert_allclose(ef, want, rtol=1e-5, atol=1e-7)


def test_consensus_gauge_matches_oracle_and_decays(hosted):
    """Each rank's ``opt.consensus_dist`` is its distance to its
    in-neighbours' mean (the combine-weighted mean of the uniform weights)
    before the step, to 1e-3, and decays; push-sum leaves the gauge."""
    port, _, _, inp = hosted
    X = np.concatenate([inp["b"], inp["w"].reshape(N, -1)],
                       axis=1).astype(np.float64)
    topo = jbf.topology_util.ExponentialTwoGraph(N)
    nbrs = {r: jbf.topology_util.in_neighbor_ranks(topo, r)
            for r in range(N)}
    Wm = np.zeros((N, N))
    for r in range(N):
        Wm[r, r] = 1.0 / (len(nbrs[r]) + 1)
        for s in nbrs[r]:
            Wm[r, s] = 1.0 / (len(nbrs[r]) + 1)
    oracle = []
    for _ in range(CONSENSUS_STEPS):
        oracle.append([np.linalg.norm(
            X[r] - np.mean([X[s] for s in nbrs[r]], axis=0))
            for r in range(N)])
        X = Wm @ X
    oracle = np.array(oracle)
    for r in range(N):
        got = port[r]["cons.gauges"]
        np.testing.assert_allclose(got, oracle[:, r], rtol=1e-3, atol=1e-9)
        assert got[-1] < 0.2 * got[0]
        assert float(port[r]["cons.ps_gauge"]) == -1.0


def test_unsynchronized_steps_under_the_default_mutex(hosted):
    """Steps with no barrier, each gossip under the hoisted mutex: finite
    values, and push-sum's p plus its pending p mail sums to 4 after a
    fence (1e-12)."""
    port, _, _, _ = hosted
    for r in range(N):
        assert bool(port[r]["mx.put.finite"])
    total = float(port[0]["mx.ps.p_all"].sum()) + sum(
        float(port[r]["mx.ps.p_mail"]) for r in range(N))
    assert abs(total - N) < 1e-12, total


def test_rejoin_put_adopts_the_donor_row_and_counter(hosted):
    port, _, _, _ = hosted
    np.testing.assert_array_equal(port[0]["put.rejoined_w"],
                                  port[DONOR]["put.w"])
    np.testing.assert_array_equal(port[0]["put.rejoined_b"],
                                  port[DONOR]["put.b"])
    assert int(port[0]["put.counter"]) == REJOIN_STEPS
    assert bool(port[0]["put.quarantine_done"])


def test_rejoin_pushsum_mass_split_is_bit_exact(hosted):
    """The donor halves its numerator row and p; the rejoiner installs the
    other half: the halves sum back to the donor's row bit for bit, each p
    is exactly half, and the rejoiner minted nothing."""
    port, _, _, _ = hosted
    donor, rej = port[DONOR], port[0]
    before, after = donor["ps.donor_row"], donor["ps.donor_after_row"]
    np.testing.assert_array_equal(after, rej["ps.rejoiner_row"])
    np.testing.assert_array_equal(after + rej["ps.rejoiner_row"], before)
    assert float(donor["ps.donor_after_p"]) == float(donor["ps.donor_p"]) * 0.5
    assert float(rej["ps.rejoiner_p"]) == float(donor["ps.donor_p"]) * 0.5
    assert float(rej["ps.rejoiner_minted"]) == 0.0
    # its de-biased parameters are the donor's
    p = float(rej["ps.rejoiner_p"])
    x = (before / float(donor["ps.donor_p"]))[4:].reshape(6, 4)
    np.testing.assert_allclose(rej["ps.rejoined_w"], x, rtol=1e-6)
    np.testing.assert_allclose(
        (rej["ps.rejoiner_row"] / p)[4:].reshape(6, 4), x, rtol=1e-6)


def test_rejoin_sharded_transfer_from_one_donor(hosted):
    port, _, _, _ = hosted
    assert port[0]["sh.shards"].tolist() == [0, 1]
    counter, rounds = port[0]["sh.rounds"].tolist()
    assert rounds == counter  # realigned: k = 1
    # identical parameters on every rank: the gossip keeps them (f32)
    np.testing.assert_allclose(port[0]["sh.rejoined_w"], port[DONOR]["sh.w"],
                               atol=1e-6)


def test_rejoin_checkpoint_fallback_remints_p(hosted):
    port, _, _, _ = hosted
    np.testing.assert_array_equal(port[0]["ck.rejoined_w"],
                                  port[0]["ck.saved_w"])
    assert float(port[0]["ck.p"]) == 1.0
    assert float(port[0]["ck.minted"]) == 1.0
    assert int(port[0]["ck.counter"]) == 2


# ---------------------------------------------------------------------------
# world 4: a SIGKILLed rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def killed(coll, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("winopt_kill")
    _, _, inp = coll
    np.savez(tmp / "inputs.npz", **inp)
    srv = native.ControlPlaneServer(N, 0)
    mp = pytest.MonkeyPatch()
    try:
        for k, v in {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(srv.port),
                     "BFT_CP_SERVE": "0", "BFT_CP_CONNECT_TIMEOUT": "60",
                     "BFT_HEARTBEAT_INTERVAL": "0.1",
                     "BFT_HEARTBEAT_TIMEOUT": "1.0",
                     "BFT_FLIGHT_DIR": str(tmp)}.items():
            mp.setenv(k, v)
        mp.delenv("BFT_WIN_PLANE", raising=False)
        port = run_world("winopt_kill", str(tmp), N, timeout=240,
                         killed=(VICTIM,))
    finally:
        mp.undo()
        srv.stop()
    cfg = CONFIGS["put"]
    kill_cfg = cfg[:5] + (KILL_AT + AFTER_KILL,)
    jx = _jax_hosted(inp, {"put": kill_cfg}, dead_from=KILL_AT + 1,
                     dead={VICTIM})
    return port, jx


def test_survivors_match_the_healed_oracle(killed):
    port, jx = killed
    survivors = [r for r in range(N) if r != VICTIM]
    _check(port, jx, "put", key="kill", ranks=survivors)
    for r in survivors:
        assert port[r]["kill.dead"].tolist() == [VICTIM]
        # one rebuild for the new dead set, no retry (no mutex was held)
        assert port[r]["kill.counters"].tolist() == [1, 0]
