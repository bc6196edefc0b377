"""Port vs JAX: the serving plane's versioned snapshots.

``bluefog_tpu_torch/serving/snapshot.py``, the counterparts of
``tests/test_serving.py:87-236``:

* the wire format: meta boundaries and their JSON, shard round trips under
  no codec, int8 and fp8, the shard payloads byte-identical to the JAX
  publisher's for the same leaves, corruption refused;
* the version fence and GC on an in-memory KV: monotone versions, the keep
  window and the GC floor, a partial publish invisible behind the fence,
  a fetch that loses the GC race retrying at the current version, the
  status reader;
* a publisher SIGKILLed mid-publish, four times, over a real control
  plane: the fence never regresses and every read at it is whole. Each
  era waits for its publisher's first committed version (a ``PUB`` line
  on its output, read with a deadline) before the kill, where JAX's test
  sleeps a fixed time and fails when the publisher starts slower;
* across the packages on one server: a JAX reader fetches a
  port-published snapshot (a bf16 leaf included) and the port reads a
  JAX-published one, equal element for element;
* the window optimizers' publisher: with ``BFT_SERVE_PUBLISH_EVERY=1`` on
  a control plane of one, each communicating step publishes the
  post-gossip parameters as version = the step counter, read back bit for
  bit; the publish gauges and counters move; a publish that fails skips
  its version and the step goes on.
"""

import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import ml_dtypes

from bluefog_tpu.ops import codec as jcd
from bluefog_tpu.runtime import native as jnative
from bluefog_tpu.serving import snapshot as jsnap
import bluefog_tpu_torch as bft
from bluefog_tpu_torch.ops import codec as cd
from bluefog_tpu_torch.runtime import metrics, native
from bluefog_tpu_torch.serving import snapshot as snap

PUB_CHILD = Path(__file__).resolve().parent / "_torch_port_serve_pub_child.py"
REPO = Path(__file__).resolve().parent.parent


class FakeKV:
    """The scalar+bytes KV surface the snapshot protocol uses, in memory."""

    def __init__(self):
        self.b, self.s = {}, {}

    def put_bytes(self, k, v):
        self.b[k] = bytes(v)

    def get_bytes(self, k):
        return self.b.get(k, b"")

    def bytes_len(self, k):
        return len(self.b.get(k, b""))

    def put_bytes_many(self, ks, vs):
        for k, v in zip(ks, vs):
            self.put_bytes(k, v)

    def get_bytes_many(self, ks):
        return [self.get_bytes(k) for k in ks]

    def put(self, k, v):
        self.s[k] = int(v)

    def get(self, k):
        return self.s.get(k, 0)

    def put_max(self, k, v):
        self.s[k] = max(self.s.get(k, 0), int(v))
        return self.s[k]

    def fetch_add(self, k, d=1):
        old = self.s.get(k, 0)
        self.s[k] = old + d
        return old


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((17, 33)).astype(np.float32),
            rng.standard_normal((5,)).astype(np.float32),
            (rng.standard_normal((64, 8)) * 3).astype(np.float32)]


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

def test_meta_boundaries_cover_and_balance():
    m = snap.SnapshotMeta.for_arrays(_leaves(), 4)
    assert m.boundaries[0] == 0 and m.boundaries[-1] == m.total
    sizes = np.diff(m.boundaries)
    assert sizes.min() >= 0 and sizes.max() - sizes.min() <= 1
    m2 = snap.SnapshotMeta.from_json(m.to_json())
    assert m2.boundaries == m.boundaries and m2.leaves == m.leaves
    assert m.to_json() == jsnap.SnapshotMeta.for_arrays(_leaves(), 4).to_json()


def test_meta_shards_clamped_to_elements():
    assert snap.SnapshotMeta([((2,), "float32")], 16).shards == 2


@pytest.mark.parametrize("spec", [None, "int8", "fp8"])
@pytest.mark.parametrize("shards", [1, 3, 5])
def test_shard_roundtrip_codecs_and_bytes_equal_jax(spec, shards):
    codec = cd.state_codec_for(cd.resolve(spec)) if spec else None
    jcodec = jcd.state_codec_for(jcd.resolve(spec)) if spec else None
    leaves = _leaves(7)
    cl, jcl = FakeKV(), FakeKV()
    snap.SnapshotPublisher(cl, shards=shards, codec=codec).publish(leaves, 3)
    jsnap.SnapshotPublisher(jcl, shards=shards, codec=jcodec).publish(
        leaves, 3)
    for s in range(shards):
        key = snap.SNAP_KEY_FMT.format(ver=3, shard=s)
        assert cl.get_bytes(key) == jcl.get_bytes(key), key
    assert cl.get_bytes(snap.META_KEY) == jcl.get_bytes(jsnap.META_KEY)
    out, ver, wire = snap.fetch_snapshot(cl)
    assert ver == 3 and len(out) == len(leaves)
    tol = 0.0 if spec is None else (0.05 if spec == "int8" else 0.5)
    for a, b in zip(leaves, out):
        assert b.shape == a.shape
        np.testing.assert_allclose(a, b, atol=tol)
    if spec == "int8":
        assert wire < sum(a.nbytes for a in leaves) / 3


def test_decode_rejects_corruption():
    cl = FakeKV()
    snap.SnapshotPublisher(cl, shards=2).publish(_leaves(1), 1)
    meta = snap.fetch_meta(cl)
    good = cl.get_bytes(snap.SNAP_KEY_FMT.format(ver=1, shard=0))
    with pytest.raises(snap.SnapshotGone):
        snap.decode_shard(b"", meta, 0, 1)
    with pytest.raises(ValueError):
        snap.decode_shard(b"\x00" * len(good), meta, 0, 1)
    with pytest.raises(ValueError):
        snap.decode_shard(good, meta, 1, 1)


def test_torch_leaves_publish_like_their_numpy_values():
    """Tensors (a bf16 one included) publish as float32 in the meta's
    order; the meta keeps the name ``bfloat16``."""
    t = [torch.linspace(-2, 2, 12).reshape(3, 4),
         torch.linspace(0, 1, 5).to(torch.bfloat16)]
    cl = FakeKV()
    snap.SnapshotPublisher(cl, shards=2).publish(t, 1)
    out, _, _ = snap.fetch_snapshot(cl)
    assert snap.fetch_meta(cl).leaves[1] == ((5,), "bfloat16")
    np.testing.assert_array_equal(out[0], t[0].numpy())
    np.testing.assert_array_equal(out[1], t[1].float().numpy())


# ---------------------------------------------------------------------------
# version fence + GC
# ---------------------------------------------------------------------------

def test_versions_are_monotone():
    cl = FakeKV()
    pub = snap.SnapshotPublisher(cl, shards=2)
    pub.publish(_leaves(), 5)
    with pytest.raises(ValueError):
        pub.publish(_leaves(), 5)
    with pytest.raises(ValueError):
        pub.publish(_leaves(), 4)
    pub.publish(_leaves(), 6)
    assert snap.current_version(cl) == 6


def test_gc_keeps_window_and_moves_floor():
    cl = FakeKV()
    pub = snap.SnapshotPublisher(cl, shards=2, keep=2)
    for v in (1, 2, 3, 4):
        pub.publish(_leaves(v), v)
    assert cl.get(snap.GC_FLOOR_KEY) == 3
    for v in (3, 4):
        assert snap.fetch_snapshot(cl, ver=v)[1] == v
    for v in (1, 2):
        with pytest.raises(snap.SnapshotGone):
            snap.fetch_snapshot(cl, ver=v)


def test_partial_publish_invisible_behind_fence():
    cl = FakeKV()
    pub = snap.SnapshotPublisher(cl, shards=3)
    one = [np.full(100, 1.0, np.float32)]
    pub.publish(one, 1)
    meta = snap.fetch_meta(cl)
    flat = snap.flatten_leaves([np.full(100, 2.0, np.float32)])
    for s in (0, 1):
        cl.put_bytes(snap.SNAP_KEY_FMT.format(ver=2, shard=s),
                     snap.encode_shard(flat, meta, s, 2))
    out, ver, _ = snap.fetch_snapshot(cl)
    assert ver == 1
    np.testing.assert_array_equal(out[0], one[0])


def test_fetch_retries_past_gc_race():
    cl = FakeKV()
    pub = snap.SnapshotPublisher(cl, shards=2, keep=2)
    for v in (1, 2, 3):
        pub.publish([np.full(50, float(v), np.float32)], v)
    meta = snap.fetch_meta(cl)
    state = {"first": True}

    def racy_pull(keys):
        if state["first"]:
            state["first"] = False
            return [b""] * len(keys)
        return cl.get_bytes_many(keys)

    out, ver, _ = snap.fetch_snapshot(cl, meta=meta, pull=racy_pull)
    assert ver == 3
    np.testing.assert_array_equal(out[0], np.full(50, 3.0, np.float32))


def test_read_serve_status_fields():
    cl = FakeKV()
    assert snap.read_serve_status(cl) is None
    snap.SnapshotPublisher(cl, shards=2).publish(_leaves(), 7, step=7)
    st = snap.read_serve_status(cl)
    assert st["version"] == 7 and st["pub_step"] == 7
    assert st["shards"] == 2 and st["publish_lag_s"] < 5.0


def test_client_slots_claim_release_and_live_ids(monkeypatch):
    monkeypatch.setenv("BFT_SERVE_CLIENT_TTL_S", "30")
    cl = FakeKV()
    a, b = snap.claim_client_slot(cl), snap.claim_client_slot(cl)
    assert (a, b) == (0, 1)
    assert snap.live_client_ids(cl) == [0, 1]
    snap.release_client_slot(cl, a)
    assert snap.live_client_ids(cl) == [1]
    assert snap.claim_client_slot(cl) == 0  # the freed slot is reused


# ---------------------------------------------------------------------------
# SIGKILL mid-publish over a real control plane
# ---------------------------------------------------------------------------

def _fence_values_consistent(cl):
    got = snap.fetch_snapshot(cl)
    if got is None:
        return 0
    out, ver, _ = got
    for leaf in out:
        np.testing.assert_array_equal(
            leaf, np.full(leaf.shape, float(ver), np.float32),
            err_msg=f"TORN READ at committed version {ver}")
    return ver


def _lines(proc):
    q = queue.Queue()

    def pump():
        for line in proc.stdout:
            q.put(line)
        q.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return q


def test_sigkill_mid_publish_never_torn():
    """The fence never regresses and no read at it is torn while the
    publisher is SIGKILLed four times. Each kill comes once that era's
    publisher has committed a version (its first ``PUB`` line, waited for
    with a deadline), so it lands in a later publish, shards half written
    (the inter-shard sleep), whatever the machine's load."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with native.ControlPlaneServer(world=2) as srv:
        cl = native.ControlPlaneClient("127.0.0.1", srv.port, rank=0)
        last_fence = 0
        next_ver = 1
        for era in range(4):
            proc = subprocess.Popen(
                [sys.executable, str(PUB_CHILD), "--port", str(srv.port),
                 "--start-ver", str(next_ver), "--shards", "4",
                 "--inter-shard-ms", "15"],
                stdout=subprocess.PIPE, text=True, env=env)
            try:
                line = _lines(proc).get(timeout=60)
                assert line and line.startswith("PUB"), line
                time.sleep(0.03 * era)  # into the next publish's shards
            finally:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
            fence = _fence_values_consistent(cl)
            assert fence >= max(last_fence, next_ver), \
                f"fence {fence} after era {era} (last {last_fence})"
            last_fence = fence
            next_ver = fence + 3  # skip the torn slot
        cl.close()


# ---------------------------------------------------------------------------
# across the packages, on one server
# ---------------------------------------------------------------------------

def test_jax_reads_port_snapshot_and_port_reads_jax():
    t = [torch.randn(9, 7, generator=torch.Generator().manual_seed(3)),
         torch.linspace(-1, 1, 10).to(torch.bfloat16)]
    with native.ControlPlaneServer(world=2) as srv:
        pcl = native.ControlPlaneClient("127.0.0.1", srv.port, rank=0)
        jcl = jnative.ControlPlaneClient("127.0.0.1", srv.port, rank=1)
        snap.SnapshotPublisher(pcl, shards=3).publish(t, 4)
        out, ver, _ = jsnap.fetch_snapshot(jcl)
        assert ver == 4
        np.testing.assert_array_equal(out[0], t[0].numpy())
        np.testing.assert_array_equal(out[1], t[1].float().numpy())
        jl = [np.arange(12, dtype=np.float32).reshape(3, 4),
              np.linspace(0, 2, 6).astype(ml_dtypes.bfloat16)]
        pcl.put_bytes(snap.META_KEY, b"")
        jpub = jsnap.SnapshotPublisher(jcl, shards=2)
        jpub.publish(jl, 9)
        out, ver, _ = snap.fetch_snapshot(pcl)
        assert ver == 9
        np.testing.assert_array_equal(out[0], jl[0])
        np.testing.assert_array_equal(out[1], jl[1].astype(np.float32))
        pcl.close()
        jcl.close()


# ---------------------------------------------------------------------------
# the window optimizers' publisher
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture()
def hosted1(monkeypatch, tmp_path):
    for k, v in {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(_free_port()),
                 "BFT_WIN_PLANE": "hosted", "BFT_FLIGHT_DIR": str(tmp_path),
                 "BFT_CYCLE_TIME": "600000",
                 "BFT_SERVE_PUBLISH_EVERY": "1"}.items():
        monkeypatch.setenv(k, v)
    bft.init(device="cpu")
    yield bft
    bft.shutdown()


@pytest.mark.parametrize("cls", ["DistributedWinPutOptimizer",
                                 "DistributedPullGetOptimizer",
                                 "DistributedPushSumOptimizer"])
def test_optimizer_publishes_post_gossip_parameters(hosted1, cls):
    from bluefog_tpu_torch.runtime import control_plane as cp

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                                torch.nn.Linear(5, 2))
    opt = getattr(bft, cls)(torch.optim.SGD(model.parameters(), lr=0.1),
                            model, lambda m, x: (m(x) ** 2).mean(),
                            num_steps_per_communication=2)
    pubs = metrics.counter("serve.publishes").value
    x = torch.ones(3, 6)
    for step in range(1, 5):
        opt.step(x)
        got = snap.fetch_snapshot(cp.client())
        if step % 2:
            continue
        out, ver, wire = got
        assert ver == step
        for a, p in zip(out, model.parameters()):
            np.testing.assert_array_equal(a, p.detach().numpy())
    assert metrics.counter("serve.publishes").value == pubs + 2
    assert metrics.gauge("serve.version").value == 4
    opt.free()


def test_failed_publish_skips_the_version_not_the_step(hosted1):
    from bluefog_tpu_torch.runtime import control_plane as cp

    model = torch.nn.Linear(4, 1)
    opt = bft.DistributedWinPutOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), model,
        lambda m, x: (m(x) ** 2).mean())
    x = torch.ones(2, 4)
    opt.step(x)
    assert snap.current_version(cp.client()) == 1

    def refuse(*a, **k):
        raise OSError("wire down")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(snap.SnapshotPublisher, "publish", refuse)
        opt.step(x)                # the step goes on
        assert snap.current_version(cp.client()) == 1
    opt.step(x)
    assert snap.current_version(cp.client()) == 3
    opt.free()
