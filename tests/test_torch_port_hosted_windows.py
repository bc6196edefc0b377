"""Port vs JAX: the hosted window plane (deposits over the control plane).

**World 4.** The test process serves a control plane of 4 and four gloo
processes (``tests/_torch_port_child.py`` mode ``win_hosted``) attach to
it through ``bf.init``, with no ``BFT_WIN_PLANE``: the hosted plane is the
default. They run the scenarios of ``tests/_torch_port_win_child.py`` on
``ExponentialTwoGraph(4)`` with ``require_mutex`` (a barrier after each
one-sided write, so every deposit has landed before a read) and every
result must equal the JAX package's collective run of the same scenario on
4 CPU devices (f32 to 1e-6, bf16 to one ulp of the largest value;
versions of every rank read through the server, p and the integer window
exactly). The same run:

* checks the plane choice, the ``_ControlPlaneWinHost`` backend, the
  ``win.put_sec``/``win.update_sec`` histograms and the drain counters
  (``tests/test_metrics.py::test_win_op_histograms_and_drain_counters``);
* runs ``tests/test_hosted_windows.py``'s concurrency tests across the
  four processes: each alternates ``require_mutex`` accumulates with
  strict ``require_mutex`` collects, unsynchronized; every unit is
  collected once;
* has an outside client hold the window mutexes: a ``require_mutex`` put
  waits until it releases, and ``win_mutex`` keeps the outside client out
  (``tests/test_control_plane.py``'s window tests);
* ``tests/_onesided_child.py``'s two properties on ``RingGraph(4)``: with
  ranks 2 and 3 asleep for 3 s, ranks 0 and 1 finish 5 rounds of put +
  update within 2.5 s with exact values, and the sleepers then fold what
  was deposited; under skewed push-sum the fast ranks finish first, and
  after a final drain the numerators sum to the inputs' 10 (1e-3) and p to
  4 (1e-9);
* writes a timeline per rank: a ``WIN_DEPOSIT`` flow starts in one rank's
  trace and finishes, with the same id, in another's;
* runs the scenarios once more on the collective plane with the control
  plane attached (scalars on the server).

**World 1**, in process, a control plane of one with ``BFT_WIN_PLANE=
hosted``: deposits are injected into slot 0 of rank 0 as a remote origin
would, the counterparts of ``tests/test_hosted_windows.py``'s wire tests
(chunked reassembly, bf16 wire, orphaned continuations, out-of-order
chunks, fence, strict mode, striped multi-origin and concurrent-clear
stress), ``_pack_deposit``'s records byte-identical to JAX's, records JAX
packed folding to the slot JAX's own drain gives, the published state
codec, the tuner's codec lever reaching ``Window.set_edge_codec``, and
``set_topology`` refused while a window exists.
"""

import json
import socket
import struct
import threading

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as bft
from bluefog_tpu.ops import codec as jcd
from bluefog_tpu.ops import windows as jw
from bluefog_tpu.runtime import control_plane as jcp
from bluefog_tpu_torch.ops import codec as cd
from bluefog_tpu_torch.ops import windows as W
from bluefog_tpu_torch.runtime import control_plane as cp
from bluefog_tpu_torch.runtime import metrics, native
from conftest import cpu_devices
from _torch_port_child import run_world
from _torch_port_win_child import SLEEP_BOUND_S
from test_torch_port_win_ops import (N, SCENARIOS, assert_rank_close, inputs,
                                     jax_results)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# world 4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hosted_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("win_hosted")
    inp = inputs()
    np.savez(tmp / "inputs.npz", **inp)
    srv = native.ControlPlaneServer(N, 0)
    mp = pytest.MonkeyPatch()
    try:
        for k, v in {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(srv.port),
                     "BFT_CP_SERVE": "0", "BFT_CP_CONNECT_TIMEOUT": "60",
                     "BFT_TIMELINE": str(tmp / "tl_"),
                     "BFT_FLIGHT_DIR": str(tmp)}.items():
            mp.setenv(k, v)
        mp.delenv("BFT_WIN_PLANE", raising=False)
        port = run_world("win_hosted", str(tmp), N, timeout=240)
    finally:
        mp.undo()
        srv.stop()
    return jax_results(inp), port, tmp


@pytest.mark.parametrize("plane", ["hosted", "cpcoll"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_world4_matches_jax(hosted_run, plane, scenario):
    jx, port, _ = hosted_run
    want = jx[f"expo2.{scenario}"]
    key = f"{plane}.{scenario}"
    for r in range(N):
        if scenario == "versions":
            # every rank's versions, read through the server
            np.testing.assert_array_equal(port[r][key], want, err_msg=key)
        else:
            assert_rank_close(port[r][key], want[r], key)


def test_world4_plane_backend_and_metrics(hosted_run):
    _, port, _ = hosted_run
    for r in range(N):
        assert port[r]["hosted_checks"].all(), (r, port[r]["hosted_checks"])
        assert port[r]["cpcoll_backend"].all(), r


def test_world4_outside_mutex_holder_excludes(hosted_run):
    _, port, _ = hosted_run
    out = port[0]
    assert bool(out["mutex_blocked"]), "put went through a held mutex"
    assert bool(out["mutex_released"]), "put never completed after release"
    assert bool(out["mutex_excluded"]), "outside client took a held mutex"
    assert bool(out["mutex_regained"])


def test_world4_concurrent_accumulates_exact_under_strict(hosted_run):
    """Unsynchronized ``require_mutex`` accumulates and strict collects
    across the processes: every rank collects exactly 2 x rounds x
    in-degree units, and no error."""
    _, port, _ = hosted_run
    for r in range(N):
        assert bool(port[r]["hammer_errors"]), r
        assert float(port[r]["hammer_collected"]) == \
            float(port[r]["hammer_expected"]), r


def test_world4_progress_with_two_ranks_asleep(hosted_run):
    x = inputs()["ring_x"]
    _, port, _ = hosted_run
    # RingGraph(4): r <- {r-1, r+1}; only the awake ranks 0, 1 deposited
    want = {0: (x[0] + x[1]) / 3.0, 1: (x[1] + x[0]) / 3.0,
            2: (x[2] + x[1]) / 3.0, 3: (x[3] + x[0]) / 3.0}
    for r in range(N):
        np.testing.assert_allclose(port[r]["sleep_got"], want[r], rtol=1e-6)
    for r in (0, 1):
        assert float(port[r]["sleep_dt"]) < SLEEP_BOUND_S, port[r]["sleep_dt"]


def test_world4_skewed_pushsum_conserves_mass(hosted_run):
    _, port, _ = hosted_run
    for r in range(N):
        assert abs(float(port[r]["skew_total"]) - 10.0) < 1e-3
        assert abs(float(port[r]["skew_p"].sum()) - 4.0) < 1e-9
    for r in (0, 1):
        assert bool(port[r]["skew_uncoupled"]), "fast ranks were held back"


def test_world4_deposit_drain_flow_pair(hosted_run):
    _, _, tmp = hosted_run
    starts, finishes = {}, {}
    for r in range(N):
        with open(tmp / f"tl_{r}.json") as f:
            events = json.load(f)
        for e in events:
            if e.get("cat") == "bf.flow" and e.get("name") == "WIN_DEPOSIT":
                (starts if e["ph"] == "s" else finishes).setdefault(
                    e["id"], set()).add(r)
    pairs = [(fid, o, d) for fid, origins in starts.items()
             for o in origins for d in finishes.get(fid, ()) if d != o]
    assert pairs, (len(starts), len(finishes))
    # the id is the deposit tag's (origin << 32 | counter) sequence
    for fid, origin, _ in pairs:
        assert fid >> 32 == origin


# ---------------------------------------------------------------------------
# world 1, in process
# ---------------------------------------------------------------------------

# BFT_CYCLE_TIME: the stall watchdog, which polls the dump trigger through
# the control-plane client in a job of one controller, waits out each test
@pytest.fixture()
def port_hosted(monkeypatch, tmp_path):
    for k, v in {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(_free_port()),
                 "BFT_CP_WORLD": "1", "BFT_CP_RANK": "0",
                 "BFT_WIN_PLANE": "hosted", "BFT_CYCLE_TIME": "600000",
                 "BFT_FLIGHT_DIR": str(tmp_path)}.items():
        monkeypatch.setenv(k, v)
    bft.init(device="cpu")
    assert cp.active()
    yield bft
    bft.shutdown()


def _inject(key, recs, seq=1, origin=0):
    recs = list(recs)
    cp.client().append_bytes_tagged_many(
        [key] * len(recs), recs, W._deposit_tags(seq, len(recs), origin))


def _window(name, x, zero_init=True):
    assert bft.win_create(x, name, zero_init=zero_init)
    win = W._get_window(name)
    assert win.hosted and win.owned == [0] and win.layout.d_max == 1
    return win


def test_wire_dtype_rule():
    """Float windows ship their own dtype (bf16 as its bit patterns),
    integer windows f32: JAX's rule, byte width for byte width."""
    import ml_dtypes

    pairs = [(torch.float32, np.float32), (torch.float64, np.float64),
             (torch.float16, np.float16), (torch.bfloat16, ml_dtypes.bfloat16),
             (torch.int32, np.int32)]
    for t, j in pairs:
        mail = W._win_mail_dtype(t)
        jwire = jw._win_wire_dtype(np.dtype(j) if j is not ml_dtypes.bfloat16
                                   else ml_dtypes.bfloat16)
        assert W._win_wire_dtype(mail).itemsize == np.dtype(jwire).itemsize
    assert W._win_wire_dtype(torch.bfloat16) == cd.BF16
    assert W._win_wire_dtype(W._win_mail_dtype(torch.int32)) == np.float32


RECORD_CASES = {
    "acc_p": dict(mode=1, has_p=1, pc=2.5, n=50_000),
    "put_small": dict(mode=0, has_p=0, pc=0.0, n=3),
    "int8_put": dict(mode=0, has_p=0, pc=0.0, n=40_000, codec="int8",
                     wt=0.25),
    "fp8_acc_shard": dict(mode=1, has_p=1, pc=0.125, n=70_001, codec="fp8",
                          wt=2.0, shard=3),
    "topk_put": dict(mode=0, has_p=1, pc=1.0, n=30_000, codec="topk:0.1",
                     wt=1.0),
    "raw_shard": dict(mode=0, has_p=0, pc=0.0, n=20_000, shard=0),
}


def _records(pkg_w, pkg_cd, case, payload):
    codec = case.get("codec")
    if codec:
        c = pkg_cd.resolve(codec)
        payload = c.encode(payload)
        return pkg_w._pack_deposit(case["mode"], case["has_p"], case["pc"],
                                   payload, codec_id=c.cid, wt=case["wt"],
                                   shard=case.get("shard", -1))
    return pkg_w._pack_deposit(case["mode"], case["has_p"], case["pc"],
                               payload, shard=case.get("shard", -1))


@pytest.mark.parametrize("case", list(RECORD_CASES))
def test_pack_deposit_records_identical_to_jax(case, monkeypatch):
    """Header, codec extension, shard flag, has_p and the 64 KiB chunking:
    the port's records are JAX's, byte for byte, as are the tags."""
    monkeypatch.setenv("BLUEFOG_MAX_WIN_SENT_LENGTH", str(1 << 16))
    monkeypatch.setenv("BFT_MAX_WIN_SENT_LENGTH", str(1 << 16))
    c = RECORD_CASES[case]
    x = np.random.default_rng(3).standard_normal(c["n"]).astype(np.float32)
    mine = _records(W, cd, c, x)
    theirs = _records(jw, jcd, c, x)
    assert [bytes(r) for r in mine] == [bytes(r) for r in theirs]
    assert all(memoryview(r).nbytes <= 1 << 16 for r in mine[1:])
    assert W._deposit_tags(7, 5, origin=3) == jw._deposit_tags(7, 5,
                                                               origin=3)


def _jax_hosted_fold(monkeypatch, case, rows):
    """JAX's drain of JAX-packed records into slot 0 of a world-1 hosted
    window: the reference result."""
    for k, v in {"BLUEFOG_CP_HOST": "127.0.0.1",
                 "BLUEFOG_CP_PORT": str(_free_port()),
                 "BLUEFOG_CP_WORLD": "1", "BLUEFOG_CP_RANK": "0",
                 "BLUEFOG_WIN_PLANE": "hosted", "BLUEFOG_CYCLE_TIME": "600000",
                 "BLUEFOG_MAX_WIN_SENT_LENGTH": str(1 << 16)}.items():
        monkeypatch.setenv(k, v)
    jcp.reset_for_test()
    jbf.init(devices=cpu_devices(1))
    try:
        import jax.numpy as jnp

        jbf.win_create(jnp.zeros((1, rows[0].size), jnp.float32), "jf",
                       zero_init=True)
        win = jw._get_window("jf")
        if case.get("shard", -1) >= 0:
            win.bind_shard(4, case["shard"])
        recs_all = [_records(jw, jcd, case, r) for r in rows]
        for seq, recs in enumerate(recs_all, 1):
            jcp.client().append_bytes_tagged_many(
                [win._dep_key(0, 0)] * len(recs), recs,
                jw._deposit_tags(seq, len(recs)))
        win._drain_deposits()
        slot = np.array(win._mail_rows[0][0])
        p_mail = win.host.read_p_mail_owned()[0].copy()
        jbf.win_free("jf")
        return recs_all, slot, p_mail
    finally:
        jbf.shutdown()
        jcp.reset_for_test()


@pytest.mark.parametrize("case", list(RECORD_CASES))
def test_jax_records_fold_like_jax_drain(case, monkeypatch, tmp_path):
    """Records the JAX package packed (two deposits on one key), injected
    into a port mailbox, fold to the slot (and p mail) JAX's drain gives,
    bit for bit."""
    c = RECORD_CASES[case]
    rng = np.random.default_rng(5)
    rows = [rng.standard_normal(c["n"]).astype(np.float32) for _ in range(2)]
    recs_all, want, want_p = _jax_hosted_fold(monkeypatch, c, rows)
    for k, v in {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(_free_port()),
                 "BFT_CP_WORLD": "1", "BFT_CP_RANK": "0",
                 "BFT_WIN_PLANE": "hosted", "BFT_CYCLE_TIME": "600000",
                 "BFT_FLIGHT_DIR": str(tmp_path)}.items():
        monkeypatch.setenv(k, v)
    bft.init(device="cpu")
    try:
        win = _window("pf", torch.zeros(c["n"]))
        if c.get("shard", -1) >= 0:
            win.bind_shard(4, c["shard"])
        for seq, recs in enumerate(recs_all, 1):
            _inject(win._dep_key(0, 0), [bytes(r) for r in recs], seq)
        win._drain_deposits()
        np.testing.assert_array_equal(win._mail_rows[0][0], want)
        np.testing.assert_array_equal(win.host.read_p_mail_owned()[0], want_p)
        bft.win_free("pf")
    finally:
        bft.shutdown()


def test_chunked_deposit_drain_reassembles(port_hosted, monkeypatch):
    monkeypatch.setenv("BFT_MAX_WIN_SENT_LENGTH", str(1 << 16))
    elems = 40_000  # 160 KB of f32 -> a header and 3 chunks
    win = _window("h.chunk", torch.zeros(elems))
    contrib = np.arange(elems, dtype=np.float32)
    cp.client().fetch_add("w.h.chunk.v.0.0", 1)
    recs = W._pack_deposit(W._DEP_ACC, 0, 0.0, contrib)
    assert len(recs) == 4
    _inject(win._dep_key(0, 0), recs)
    win._drain_deposits()
    np.testing.assert_array_equal(win._mail_rows[0][0], contrib)
    assert bft.get_win_version("h.chunk", rank=0) == {}
    bft.win_free("h.chunk")


def test_bf16_deposit_wire_roundtrip(port_hosted):
    """A bf16 window's deposit ships bf16 bytes (8 for 4 values) and folds
    with f32 accumulation."""
    import ml_dtypes

    win = _window("h.bf16", torch.ones(4, dtype=torch.bfloat16))
    contrib = np.asarray([1.5, 2.5, 3.5, 4.5], ml_dtypes.bfloat16)
    recs = jw._pack_deposit(jw._DEP_ACC, 0, 0.0, contrib)
    assert memoryview(recs[1]).nbytes == 8
    _inject(win._dep_key(0, 0), [bytes(r) for r in recs])
    _inject(win._dep_key(0, 0), [bytes(r) for r in recs], seq=2)
    win._drain_deposits()
    got = cd.to_f32(win._mail_rows[0][0])
    np.testing.assert_array_equal(got, 2 * np.asarray(contrib, np.float32))
    bft.win_free("h.bf16")


def test_clear_discards_orphaned_continuation_chunks(port_hosted,
                                                     monkeypatch):
    monkeypatch.setenv("BFT_MAX_WIN_SENT_LENGTH", str(1 << 16))
    elems = 40_000
    win = _window("h.orph", torch.zeros(elems))
    key = win._dep_key(0, 0)
    contrib = np.arange(elems, dtype=np.float32)
    recs = W._pack_deposit(W._DEP_ACC, 0, 0.0, contrib)
    tags = W._deposit_tags(7, len(recs))
    # a clear ate seq 7's header and first chunk: only its tail is there
    cp.client().append_bytes_tagged_many([key] * 2, recs[2:], tags[2:])
    _inject(key, recs, seq=8)
    before = metrics.snapshot()["counters"].get("win.drain_orphans", 0)
    win._drain_deposits()
    np.testing.assert_array_equal(win._mail_rows[0][0], contrib)
    assert metrics.snapshot()["counters"]["win.drain_orphans"] == before + 2
    bft.win_free("h.orph")


def test_out_of_order_chunk_reassembly(port_hosted, monkeypatch):
    monkeypatch.setenv("BFT_MAX_WIN_SENT_LENGTH", str(1 << 16))
    elems = 40_000
    win = _window("h.ooo", torch.zeros(elems))
    key = win._dep_key(0, 0)
    contrib = np.arange(elems, dtype=np.float32)
    recs = W._pack_deposit(W._DEP_ACC, 0, 0.0, contrib)
    tags = W._deposit_tags(5, len(recs))
    order = [0, 3, 2, 1]  # header first, then the chunks reversed
    cp.client().append_bytes_tagged_many(
        [key] * 4, [recs[i] for i in order], [tags[i] for i in order])
    win._drain_deposits()
    np.testing.assert_array_equal(win._mail_rows[0][0], contrib)
    bft.win_free("h.ooo")


def test_win_fence_folds_pending_deposits(port_hosted):
    win = _window("h.fence", torch.zeros(2))
    cp.client().fetch_add("w.h.fence.v.0.0", 1)
    contrib = np.full((2,), 7.0, np.float32)
    _inject(win._dep_key(0, 0),
            [struct.pack("<BBdI", 1, 0, 0.0, 1) + contrib.tobytes()])
    assert bft.win_fence("h.fence")
    assert cp.client().take_bytes(win._dep_key(0, 0)) == []
    np.testing.assert_array_equal(win._mail_rows[0][0], contrib)
    bft.win_free("h.fence")


def test_strict_update_rejects_version0_deposit(port_hosted, monkeypatch):
    monkeypatch.setenv("BFT_WIN_STRICT", "1")
    win = _window("h.strict", torch.zeros(2))
    rec = struct.pack("<BBdI", 1, 0, 0.0, 1) + np.ones(2, np.float32).tobytes()
    _inject(win._dep_key(0, 0), [rec], seq=1)
    with pytest.raises(RuntimeError, match="version 0"):
        bft.win_update("h.strict", require_mutex=True)
    cp.client().fetch_add("w.h.strict.v.0.0", 1)
    _inject(win._dep_key(0, 0), [rec], seq=2)
    bft.win_update("h.strict", require_mutex=True)
    np.testing.assert_array_equal(win._mail_rows[0][0], [2.0, 2.0])
    bft.win_free("h.strict")


def test_multi_origin_striped_deposit_stress(port_hosted, monkeypatch):
    """Two origins, each on its own striped pool and tag namespace, hammer
    one mailbox with chunked deposits while the owner drains and fences:
    every deposited unit folds exactly once."""
    monkeypatch.setenv("BFT_MAX_WIN_SENT_LENGTH", str(1 << 16))
    monkeypatch.setenv("BFT_CP_STRIPE_MIN_MB", "0.0625")
    monkeypatch.setenv("BFT_CP_STREAMS", "4")
    elems = 80_000
    win = _window("h.multi", torch.zeros(elems))
    key = win._dep_key(0, 0)
    contrib = np.ones(elems, np.float32)
    ROUNDS, DEPS = 6, 3
    errors, collected = [], [0.0]

    def origin(i):
        cl = cp.extra_client()
        try:
            for seq in range(1, ROUNDS * DEPS + 1):
                recs = W._pack_deposit(W._DEP_ACC, 0, 0.0, contrib)
                cl.append_bytes_tagged_many(
                    [key] * len(recs), recs,
                    W._deposit_tags(seq, len(recs), origin=i + 1))
        except Exception as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)
        finally:
            cl.close()

    def take():
        with win.state_mu:
            win._drain_deposits()
            collected[0] += float(win._mail_rows[0][0].sum(dtype=np.float64))
            win._mail_rows[0][0][...] = 0.0

    threads = [threading.Thread(target=origin, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        take()
        bft.win_fence("h.multi")
    for t in threads:
        t.join(30)
    take()
    assert not errors, errors
    assert collected[0] == 2 * ROUNDS * DEPS * elems
    bft.win_free("h.multi")


def test_concurrent_clear_during_deposit_stress(port_hosted, monkeypatch):
    """Clears racing chunked deposits (sent in two halves) never crash a
    drain, and the window still folds a fresh deposit exactly."""
    monkeypatch.setenv("BFT_MAX_WIN_SENT_LENGTH", str(1 << 16))
    monkeypatch.setenv("BFT_WIN_DRAIN_TIMEOUT", "30")
    elems = 40_000
    win = _window("h.race", torch.zeros(elems))
    key = win._dep_key(0, 0)
    contrib = np.ones(elems, np.float32)
    stop = threading.Event()
    errors = []

    def depositor():
        cl = cp.extra_client()
        seq = 100
        try:
            while not stop.is_set():
                recs = W._pack_deposit(W._DEP_ACC, 0, 0.0, contrib)
                tags = W._deposit_tags(seq, len(recs))
                seq += 1
                cl.append_bytes_tagged_many([key] * 2, recs[:2], tags[:2])
                cl.append_bytes_tagged_many([key] * (len(recs) - 2),
                                            recs[2:], tags[2:])
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)
        finally:
            cl.close()

    t = threading.Thread(target=depositor)
    t.start()
    try:
        for i in range(20):
            if i % 3 == 0:
                cp.client().take_bytes(key)
            else:
                win._drain_deposits()
    finally:
        stop.set()
        t.join(30)
    assert not errors, errors
    win._drain_deposits()
    base = win._mail_rows[0][0].astype(np.float64).copy()
    _inject(key, W._pack_deposit(W._DEP_ACC, 0, 0.0, contrib), seq=999)
    win._drain_deposits()
    np.testing.assert_allclose(win._mail_rows[0][0], base + 1.0, rtol=1e-6)
    bft.win_free("h.race")


def test_deposit_over_mailbox_cap_is_a_configuration_error(port_hosted):
    win = _window("h.cap", torch.zeros(4))
    cap = cp.mailbox_cap_bytes()
    with pytest.raises(ValueError, match="BFT_CP_MAILBOX_MAX_MB"):
        W._precheck_mailbox_cap(win, [win._dep_key(0, 0)],
                                [np.zeros(cap, np.uint8)], [(1, 0, 0)])
    assert W._precheck_mailbox_cap(
        win, [win._dep_key(0, 0)], [b"x" * 64], [(1, 0, 0)]) == set()
    bft.win_free("h.cap")


@pytest.mark.parametrize("spec", ["none", "int8", "topk:0.1"])
def test_published_rows_and_state_codec(port_hosted, monkeypatch, spec):
    """``none`` publishes the raw row; int8 its encoded state behind the
    magic header; top-k falls back to int8 state. Readers decode it."""
    monkeypatch.setenv("BFT_WIN_CODEC", spec)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        8192).astype(np.float32))
    win = _window("h.pub", x, zero_init=False)
    raw = cp.client().get_bytes(win._self_key(0))
    if spec == "none":
        assert raw == x.numpy().tobytes()
    else:
        assert struct.unpack_from("<IB", raw, 0) == (W._PUB_MAGIC,
                                                     cd.CODEC_INT8)
        assert len(raw) < x.numel() * 4 / 3.5
        want = jcd.Int8Codec().decode(jcd.Int8Codec().encode(x.numpy()),
                                      np.float32, x.numel())
        np.testing.assert_array_equal(win._read_remote_selves([0])[0], want)
        np.testing.assert_array_equal(win.read_published_row(0), want)
    bft.win_free("h.pub")


def test_install_and_read_published_rows(port_hosted):
    """The rejoin hooks: ``install_row`` writes and publishes an owned row,
    ``read_published_row`` reads it back, a sharded window also reports
    the published shard index; a rank it does not own is refused; the
    ``self_value`` setter casts to the window's dtype and publishes."""
    win = _window("h.rows", torch.zeros(6), zero_init=False)
    assert win.read_published_shard(0)[1] is None
    row = np.arange(6, dtype=np.float32)
    win.install_row(0, row)
    np.testing.assert_array_equal(win.read_published_row(0), row)
    np.testing.assert_array_equal(win.self_value.numpy(), row)
    win.bind_shard(3, start=1)
    win.set_active_shard(5)
    win.install_row(0, row + 1)
    got, sidx = win.read_published_shard(0)
    np.testing.assert_array_equal(got, row + 1)
    assert sidx == 2
    with pytest.raises(ValueError, match="not owned"):
        win.install_row(1, row)
    # the setter casts a tensor of another dtype to the window's
    win.self_value = torch.arange(6, dtype=torch.float64) * 0.5
    np.testing.assert_array_equal(win.read_published_row(0), row * 0.5)
    bft.win_free("h.rows")
    assert win.read_published_row(0) is None


def test_delayed_deposit_send_orders_by_edge_delay(port_hosted):
    """The fault injector's ``delay_edges`` send ships the undelayed
    edge's records first and the delayed one's after its delay."""
    import time

    win = _window("h.dly", torch.zeros(2))
    key = win._dep_key(0, 0)
    recs = [struct.pack("<BBdI", 1, 0, 0.0, 1) + np.full(
        2, v, np.float32).tobytes() for v in (1.0, 2.0)]
    tags = W._deposit_tags(1, 1) + W._deposit_tags(2, 1)
    t0 = time.monotonic()
    replies = W._send_deposits_delayed(
        [key, key], recs, tags, [(1, 0, 0), (2, 0, 0)], {(1, 0): 150})
    assert time.monotonic() - t0 >= 0.15 and min(replies) >= 0
    got = cp.client().take_bytes(key)
    assert [bytes(r[W._DEP_TAG:]) for r in got] == [recs[1], recs[0]]
    bft.win_free("h.dly")


def test_edge_codec_switch_and_tuner_lever(port_hosted):
    """The tuner's codec decision reaches ``Window.set_edge_codec`` of an
    open hosted window and the edge's codec changes; switching back
    empties the override table."""
    from bluefog_tpu_torch.runtime import tuner

    win = _window("h.sw", torch.zeros(16))
    assert win.set_edge_codec(0, 1, "none") is False
    t = tuner.Tuner(rank=0, world=1)
    d = tuner.Decision("codec", (0, 1), "escalate", arg="int8")
    assert t._actuate(d, None) is True
    assert isinstance(win.codec_for(0, 1), cd.Int8Codec)
    assert win.set_edge_codec(0, 1, None) is True
    assert not win._edge_codec
    bft.win_free("h.sw")


def test_set_topology_refused_while_windows_exist():
    bft.init(device="cpu")
    try:
        ring = bft.topology_util.RingGraph(1)
        assert bft.win_create(torch.ones(3), "topo")
        assert bft.set_topology(ring) is False
        assert bft.win_free("topo")
        assert bft.set_topology(ring) is True
        assert bft.unified_mpi_window_model_supported() is True
    finally:
        bft.shutdown()
