"""Port vs JAX: the control plane's attach, authentication and shard router.

* the window-free cases of ``tests/test_control_plane.py`` on the port:
  the HMAC handshake (a shared secret round-trips, a wrong secret and an
  unauthenticated client are refused), the mailbox byte cap, batched
  fetch-and-add, the endpoint grammar, the replicated key classes, the
  router's stable spread, caller-ordered batches and replicated writes,
  and a single endpoint attaching as a plain client;
* the JAX and port routers place the same keys on the same shards, over
  3,000 keys at 2, 3 and 5 shards;
* ``attach`` raises at a declared world of more than one that cannot
  connect, and falls back to no control plane at a forced world of one
  (``tests/test_chaos.py``'s two attach cases);
* a ``torchrun`` environment derives the server from ``MASTER_ADDR`` and
  ``MASTER_PORT + 17``;
* a native library that is missing or does not load makes ``bf.init``
  raise when a control plane is asked for.
"""

import os
import socket
import subprocess
import sys

import pytest

from bluefog_tpu.runtime import router as jrouter
from bluefog_tpu_torch.runtime import control_plane as cp
from bluefog_tpu_torch.runtime import native, router
from bluefog_tpu_torch.runtime.router import (ShardRouter,
                                              is_replicated_key,
                                              parse_endpoints)


def _dead_port() -> int:
    """A port nothing listens on (bound once by the OS, then released)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _is_free(port: int) -> bool:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", port))
        return True
    except OSError:
        return False
    finally:
        s.close()


@pytest.fixture(autouse=True)
def _detached():
    cp.detach()
    yield
    cp.detach()


def test_auth_roundtrip_with_shared_secret():
    srv = native.ControlPlaneServer(1, 0, secret="job-secret")
    try:
        cl = native.ControlPlaneClient("127.0.0.1", srv.port, 0,
                                       secret="job-secret")
        cl.put("auth.k", 41)
        assert cl.fetch_add("auth.k", 1) == 41
        assert cl.get("auth.k") == 42
        cl.put_bytes("auth.b", b"tensor bytes")
        assert cl.get_bytes("auth.b") == b"tensor bytes"
        cl.close()
    finally:
        srv.stop()


def test_auth_rejects_wrong_secret():
    srv = native.ControlPlaneServer(1, 0, secret="right")
    try:
        with pytest.raises(OSError):
            native.ControlPlaneClient("127.0.0.1", srv.port, 0,
                                      secret="wrong")
    finally:
        srv.stop()


def test_auth_rejects_unauthenticated_client():
    """A client that never handshakes reaches no server op."""
    srv = native.ControlPlaneServer(1, 0, secret="right")
    try:
        cl = native.ControlPlaneClient("127.0.0.1", srv.port, 0)
        with pytest.raises(OSError):
            cl.put("stolen.key", 1)
        cl.close()
        good = native.ControlPlaneClient("127.0.0.1", srv.port, 0,
                                         secret="right")
        assert good.get("stolen.key") == 0
        good.close()
    finally:
        srv.stop()


def test_mailbox_byte_cap_rejects_then_recovers():
    srv = native.ControlPlaneServer(1, 0, max_mailbox_bytes=1024)
    try:
        cl = native.ControlPlaneClient("127.0.0.1", srv.port, 0)
        cl.append_bytes("box", b"x" * 800)
        with pytest.raises(RuntimeError, match="full"):
            cl.append_bytes("box", b"y" * 800)
        # the cap bounds the backlog, not one record's size
        cl.append_bytes("box2", b"z" * 2048)
        assert cl.take_bytes("box") == [b"x" * 800]
        cl.append_bytes("box", b"y" * 800)  # drained: accepted again
        assert cl.take_bytes("box") == [b"y" * 800]
        assert cl.take_bytes("box2") == [b"z" * 2048]
        cl.close()
    finally:
        srv.stop()


def test_fetch_add_many_batches_version_bumps():
    srv = native.ControlPlaneServer(1, 0)
    try:
        cl = native.ControlPlaneClient("127.0.0.1", srv.port, 0)
        assert cl.fetch_add_many(["v.a", "v.b", "v.a"]) == [0, 0, 1]
        assert cl.get("v.a") == 2 and cl.get("v.b") == 1
        assert cl.fetch_add_many(["v.a", "v.b"], deltas=[10, -1]) == [2, 1]
        assert cl.get("v.a") == 12 and cl.get("v.b") == 0
        cl.close()
    finally:
        srv.stop()


def test_parse_endpoints_grammar():
    assert parse_endpoints("a:1,b:2") == [("a", 1), ("b", 2)]
    assert parse_endpoints(" a:1 , b:2 ") == [("a", 1), ("b", 2)]
    assert parse_endpoints("") == []
    for bad in ("nocolon", "a:not_a_port"):
        with pytest.raises(ValueError):
            parse_endpoints(bad)
        with pytest.raises(ValueError):
            jrouter.parse_endpoints(bad)


def test_replicated_key_classes():
    for k in ("bf.membership.epoch", "bf.inc.3", "bf.q.2.5",
              "bf.shutdown.flag.1", "bf.shutdown.ack.0",
              "bf.cp.mailbox_cap_bytes", "bf.cp.shard_dead.0"):
        assert is_replicated_key(k) and jrouter.is_replicated_key(k), k
    for k in ("bf.hb.0", "bf.metrics.1", "bf.flight.0", "bf.flight.trigger",
              "w.opt.ver.3", "w.opt.dep.1.0", "w.opt.self.2"):
        assert not is_replicated_key(k), k
        assert not jrouter.is_replicated_key(k), k


@pytest.fixture()
def shard_trio():
    servers = [native.ControlPlaneServer(1, 0) for _ in range(3)]
    yield servers
    for s in servers:
        s.stop()


def _eps(servers):
    return [("127.0.0.1", s.port) for s in servers]


def test_router_routing_is_stable_and_spread(shard_trio):
    r = ShardRouter(_eps(shard_trio), 0, streams=1)
    names = [f"ob.{i}" for i in range(64)]
    owners = [r.shard_of(n) for n in names]
    assert owners == [r.shard_of(n) for n in names]  # pure and stable
    assert set(owners) == {0, 1, 2}                  # spread over all
    r.close()


def test_router_batches_preserve_caller_order(shard_trio):
    r = ShardRouter(_eps(shard_trio), 0, streams=1)
    names = [f"ob.{i}" for i in range(40)]
    r.put_many(names, list(range(40)))
    assert r.get_many(names) == list(range(40))
    assert r.fetch_add_many(names, deltas=[2] * 40) == list(range(40))
    assert r.get_many(names) == [i + 2 for i in range(40)]
    r.append_bytes_many(names, [str(i).encode() for i in range(40)])
    assert r.box_bytes_many(names) == [len(str(i)) for i in range(40)]
    recs = r.take_bytes_many(names)
    assert [lst[0] for lst in recs] == [str(i).encode() for i in range(40)]
    recs, owner = r.take_bytes_many_views(names)
    assert all(lst == [] for lst in recs)  # already drained
    owner.close()
    r.close()


def test_router_replicated_write_lands_on_every_shard(shard_trio):
    r = ShardRouter(_eps(shard_trio), 0, streams=1)
    r.put("bf.q.4.2", 2)
    e = r.fetch_add("bf.membership.epoch", 1)
    for s in shard_trio:
        probe = native.ControlPlaneClient("127.0.0.1", s.port, 9, streams=1)
        assert probe.get("bf.q.4.2") == 2
        assert probe.get("bf.membership.epoch") >= e + 1
        probe.close()
    r.put("bf.q.4.2", 1)  # monotone merge: a lower write cannot regress it
    assert r.get("bf.q.4.2") == 2
    r.close()


@pytest.mark.parametrize("n", [2, 3, 5])
def test_routers_place_keys_as_jax(n):
    """The port's and the JAX package's routers over the same shards give
    every key the same preferred shard and the same live owner, and one
    written through either is read through the other."""
    servers = [native.ControlPlaneServer(1, 0) for _ in range(n)]
    try:
        eps = _eps(servers)
        p = ShardRouter(eps, 0, streams=1)
        j = jrouter.ShardRouter(eps, 1, streams=1)
        keys = [f"bf.metrics.{i}" for i in range(1000)] + \
            [f"w.opt.dep.{i}.{i % 7}" for i in range(1000)] + \
            [f"k{i}/é/{i * 7919}" for i in range(1000)]
        assert [p.shard_of(k) for k in keys] == [j.shard_of(k) for k in keys]
        assert [p.owner_of(k) for k in keys[:200]] == \
            [j.owner_of(k) for k in keys[:200]]
        assert all(router._fnv64(k) == jrouter._fnv64(k) for k in keys)
        p.put_many(keys[:300], list(range(300)))
        assert j.get_many(keys[:300]) == list(range(300))
        p.close()
        j.close()
    finally:
        for s in servers:
            s.stop()


def test_shard_addr_packing_equals_jax():
    for gen, host, port in ((2, "127.0.0.1", 41000), (65535, "10.1.2.3", 1)):
        packed = router.pack_shard_addr(gen, host, port)
        assert packed == jrouter.pack_shard_addr(gen, host, port)
        assert router.unpack_shard_addr(packed) == (gen, host, port)
    assert router.unpack_shard_addr(0) is None


def test_single_endpoint_attach_stays_plain_client(monkeypatch):
    srv = native.ControlPlaneServer(1, 0)
    try:
        for k, v in {"BFT_CP_HOST": "127.0.0.1",
                     "BFT_CP_PORT": str(srv.port), "BFT_CP_WORLD": "1",
                     "BFT_CP_RANK": "0", "BFT_CP_SERVE": "0"}.items():
            monkeypatch.setenv(k, v)
        cl = cp.attach()
        assert isinstance(cl, native.ControlPlaneClient)
        assert not isinstance(cl, ShardRouter)
        assert cp.active() and cp.world() == 1 and cp.owned_ranks() == [0]
    finally:
        cp.detach()
        srv.stop()


def test_attach_raises_when_multiprocess_connect_fails(monkeypatch):
    for k, v in {"BFT_CP_HOST": "127.0.0.1",
                 "BFT_CP_PORT": str(_dead_port()), "BFT_CP_WORLD": "2",
                 "BFT_CP_RANK": "1",  # not the serving rank
                 "BFT_CP_CONNECT_TIMEOUT": "0.5"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="refusing to degrade"):
        cp.attach()
    assert not cp.active()


def test_attach_soft_fallback_for_single_controller(monkeypatch):
    for k, v in {"BFT_CP_HOST": "127.0.0.1",
                 "BFT_CP_PORT": str(_dead_port()), "BFT_CP_WORLD": "1",
                 "BFT_CP_RANK": "0", "BFT_CP_SERVE": "0",
                 "BFT_CP_CONNECT_TIMEOUT": "0.5"}.items():
        monkeypatch.setenv(k, v)
    assert cp.attach() is None
    assert not cp.active()


def test_attach_from_torchrun_env(monkeypatch):
    """Under ``torchrun`` (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``WORLD_SIZE``) rank 0 serves at ``MASTER_PORT + 17`` and connects to
    ``MASTER_ADDR``, a name resolved to its IPv4 address; a declared world of 2 whose peer never comes still
    attaches rank 0 (it serves itself). ``BFT_CP_DISABLE=1`` turns it
    off."""
    master = next(p for p in iter(_dead_port, None) if _is_free(p + 17))
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": str(master),
                 "RANK": "0", "WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BFT_CP_DISABLE", "1")
    assert cp.attach() is None
    cp.detach()
    monkeypatch.delenv("BFT_CP_DISABLE")
    cl = cp.attach()
    assert cl is not None and cp.world() == 2
    assert cp._conn_params[:3] == ("localhost", master + cp.PORT_OFFSET, 0)
    assert cl._conn[:3] == ("127.0.0.1", master + 17, 0)
    assert cp._server is not None and cp._server.port == master + 17
    cp.detach()
    assert not cp.active() and cp._server is None


def test_in_process_shards_hold_native_knobs_until_detach(monkeypatch):
    """``BFT_CP_SHARDS=2`` serves both shards in this process, and their
    replication threads read ``BLUEFOG_CP_RETRIES``/``_BACKOFF_MS``
    whenever they dial a successor, outside any call of the binding. For
    as long as the shards serve, the C library's ``getenv`` (the read the
    threads make) sees the ``BFT_*`` values under those names, a stray
    ``BLUEFOG_*`` value without its twin hidden; detach puts the
    environment back."""
    import ctypes

    getenv = ctypes.CDLL(None).getenv
    getenv.restype = ctypes.c_char_p
    monkeypatch.setenv("BLUEFOG_CP_RETRIES", "0")       # stray, no twin
    monkeypatch.setenv("BLUEFOG_CP_BACKOFF_MS", "999")  # stray
    monkeypatch.setenv("BFT_CP_BACKOFF_MS", "25")
    monkeypatch.delenv("BFT_CP_RETRIES", raising=False)
    port = next(p for p in iter(_dead_port, None) if _is_free(p + 1))
    for k, v in {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(port),
                 "BFT_CP_SHARDS": "2", "BFT_CP_WORLD": "1",
                 "BFT_CP_RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    cl = cp.attach()
    try:
        assert isinstance(cl, ShardRouter) and len(cp._servers) == 2
        assert getenv(b"BLUEFOG_CP_RETRIES") is None
        assert getenv(b"BLUEFOG_CP_BACKOFF_MS") == b"25"
        cl.put("k", 7)  # the shards serve, replicating to each other
        assert cl.get("k") == 7
    finally:
        cp.detach()
    assert cp._servers == []
    assert getenv(b"BLUEFOG_CP_RETRIES") == b"0"
    assert os.environ["BLUEFOG_CP_BACKOFF_MS"] == "999"
    assert getenv(b"BLUEFOG_CP_BACKOFF_MS") == b"999"


@pytest.mark.parametrize("library", ["missing", "not_a_library"])
def test_attach_raises_when_the_library_cannot_load(tmp_path, library):
    """No quiet fallback: a control plane asked for at world 1 whose
    native library cannot be loaded makes ``bf.init`` raise (the JAX
    package stays local instead). A fresh interpreter, since this one has
    the library loaded already."""
    so = tmp_path / "libbf_runtime.so"
    if library == "not_a_library":
        so.write_bytes(b"\x7fELF but not really")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, BFT_NATIVE_SO=str(so),
               BFT_CP_HOST="127.0.0.1", BFT_CP_PORT=str(_dead_port()))
    probe = ("import bluefog_tpu_torch as bf\n"
             "try:\n"
             "    bf.init(device='cpu')\n"
             "except RuntimeError as exc:\n"
             "    print('RAISED', exc)\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("RAISED"), res.stdout + res.stderr
    assert ("does not exist" if library == "missing" else "failed to load") \
        in res.stdout
