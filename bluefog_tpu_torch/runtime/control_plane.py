"""Process-global control plane: distributed scalar state over TCP.

Counterpart of ``bluefog_tpu/runtime/control_plane.py``: one server per
job (or N shards), one client per process, over the native library
(``runtime/native.py``). It carries what the process group cannot: the
metrics every rank publishes (``bf.metrics.<rank>``, read by
``cluster_health`` from inside the job or from outside it), the flight
recorder's KV tail and its remote dump trigger, and the mutexes, counters
and mailboxes of the modules still to come.

Activation (``bf.init`` calls :func:`attach` right after the process group
forms):

* a ``torchrun`` world of more than one rank: rank 0 serves on
  ``MASTER_PORT + 17`` (or ``BFT_CP_PORT``) and every rank connects to
  ``MASTER_ADDR``;
* forced: ``BFT_CP_HOST``/``BFT_CP_PORT`` (tests, a world of one, external
  actors), with ``BFT_CP_RANK``/``BFT_CP_WORLD`` or else the process
  group's rank and size;
* ``BFT_CP_HOSTS`` names external shard servers, ``BFT_CP_SHARDS=N``
  serves N shards in-process on rank 0;
* ``BFT_CP_DISABLE=1`` turns it off.

A world of more than one process that cannot connect raises; a forced
world of one falls back to no control plane with a warning. Each process
owns exactly its own rank: only it writes that rank's keys.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import List, Optional

from .config import knob_env
from .logging import logger
from .native import (ControlPlaneClient, ControlPlaneServer,
                     StaleIncarnationError, export_native_knobs,
                     restore_native_knobs)
from .router import ShardRouter, parse_endpoints

_mu = threading.Lock()
_client = None  # ControlPlaneClient (1 endpoint) or ShardRouter (N shards)
_server: Optional[ControlPlaneServer] = None
_servers: list = []  # in-process shard servers (BFT_CP_SHARDS > 1)
# the environment's own values of the native-scope knob names while the
# in-process shard servers hold the BFT_* values under them
_knobs_saved: Optional[dict] = None
_world: int = 1
_tried = False
_conn_params = None  # (host, port, rank, secret) of the live attachment
_endpoints = None    # [(host, port)] of a sharded attachment
_incarnation: int = 0  # incarnation this attachment registered

# the launcher's port plus this offset is the control plane's by default
PORT_OFFSET = 17


def _env_incarnation() -> int:
    """``BFT_INCARNATION``: this process's membership incarnation (0 on a
    first launch; a restarted rank attaches with the previous value + 1,
    which fences its zombie predecessor)."""
    return max(0, int(knob_env("BFT_INCARNATION")))


def _launcher():
    """``(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)`` of a ``torchrun``
    world of more than one rank (the condition under which ``bf.init``
    joins the launcher's group), else None."""
    world = os.environ.get("WORLD_SIZE")
    if not world or "MASTER_ADDR" not in os.environ or int(world) <= 1:
        return None
    return (os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]),
            int(os.environ.get("RANK", "0")), int(world))


def attach(rank: Optional[int] = None, world: Optional[int] = None):
    """Connect (starting the server when this is rank 0) when configured.

    ``rank``/``world`` are the process group's (``bf.init`` passes them);
    ``BFT_CP_RANK``/``BFT_CP_WORLD`` override them. Returns the
    process-global client, or None when the control plane is not
    configured, disabled, or a forced world of one could not connect.
    Raises when a world of more than one cannot connect, and when the
    native library cannot be built or loaded.
    """
    global _client, _server, _world, _tried, _conn_params, _incarnation
    with _mu:
        if _client is not None or _tried:
            return _client
        _tried = True
        if knob_env("BFT_CP_DISABLE"):
            return None
        host = knob_env("BFT_CP_HOST")
        port = knob_env("BFT_CP_PORT")
        if knob_env("BFT_CP_WORLD") > 0:
            rank, world = knob_env("BFT_CP_RANK"), knob_env("BFT_CP_WORLD")
        # shared-secret authentication: the job's secret rides the env;
        # without it the server accepts any TCP connect (one host, dev)
        secret = knob_env("BFT_CP_SECRET") or ""
        launcher = _launcher()
        if world is None and launcher is not None:
            rank, world = launcher[2], launcher[3]

        hosts_spec = knob_env("BFT_CP_HOSTS")
        if hosts_spec:
            return _attach_sharded(hosts_spec, 1, host, port, rank or 0,
                                   world or 0, secret)
        if host is None:
            if launcher is None:
                return None
            host = launcher[0]
            port = port or launcher[1] + PORT_OFFSET
        shards = int(knob_env("BFT_CP_SHARDS") or 1)
        if shards > 1:
            return _attach_sharded(None, shards, host, port, rank or 0,
                                   world or 0, secret)
        if port is None or not world or world <= 0:
            logger.warning("control plane env incomplete; staying local")
            return None

        served_cap = None
        if rank == 0 and knob_env("BFT_CP_SERVE"):
            max_mb = float(knob_env("BFT_CP_MAILBOX_MAX_MB"))
            try:
                _server = ControlPlaneServer(
                    world, port, secret=secret,
                    max_mailbox_bytes=int(max_mb * (1 << 20)))
                served_cap = int(max_mb * (1 << 20))
            except OSError as exc:
                # another process may already serve this port
                logger.debug("control plane server not started here (%s)",
                             exc)
                _server = None

        deadline = time.monotonic() + float(
            knob_env("BFT_CP_CONNECT_TIMEOUT"))
        last: Optional[Exception] = None
        inc = _env_incarnation()
        while time.monotonic() < deadline:
            try:
                _client = ControlPlaneClient(host, port, rank, secret=secret,
                                             incarnation=inc)
                break
            except StaleIncarnationError:
                # a newer incarnation of this rank is attached already:
                # this process must not join the job
                if _server is not None:
                    _server.stop()
                    _server = None
                raise
            except OSError as exc:
                last = exc
                time.sleep(0.2)
        if _client is None:
            if _server is not None:
                _server.stop()
                _server = None
            if world > 1:
                # a job of several processes degraded to one would publish
                # and coordinate nowhere while believing it does
                raise RuntimeError(
                    f"control plane connect to {host}:{port} failed after "
                    "BFT_CP_CONNECT_TIMEOUT with a declared world of "
                    f"{world} processes (rank {rank}): refusing to degrade "
                    "a job of several processes to local-only "
                    f"coordination. Last error: {last}")
            logger.warning("control plane connect failed (%s); staying "
                           "local", last)
            return None
        _world = world
        _conn_params = (host, port, rank, secret)
        _incarnation = inc
        if served_cap is not None:
            # the SERVING process's cap (+1, so 0 stays "not published")
            _client.put(_MAILBOX_CAP_KEY, served_cap + 1)
        logger.info("control plane attached: %s:%d rank=%d world=%d",
                    host, port, rank, world)
        return _client


def _stop_servers() -> None:
    global _servers, _knobs_saved
    for srv in _servers:
        srv.stop()
    _servers = []
    if _knobs_saved is not None:
        restore_native_knobs(_knobs_saved)
        _knobs_saved = None


def _attach_sharded(hosts_spec, shards, host, port, rank, world, secret):
    """Sharded attachment (caller holds ``_mu``): a :class:`ShardRouter`
    over N endpoints, the N shards served in-process on rank 0 when they
    are derived from one host/port, and every shard's mailbox cap checked
    to agree. Returns the router, or None."""
    global _client, _servers, _world, _conn_params, _endpoints, \
        _incarnation, _knobs_saved
    if hosts_spec:
        try:
            endpoints = parse_endpoints(hosts_spec)
        except ValueError as exc:
            raise RuntimeError(f"BFT_CP_HOSTS: {exc}") from None
        serve_here = False  # the endpoints are external shard servers
    else:
        if host is None or port is None:
            logger.warning("BFT_CP_SHARDS set without a control-plane "
                           "host/port; staying local")
            return None
        endpoints = [(host, port + i) for i in range(max(1, shards))]
        serve_here = rank == 0 and knob_env("BFT_CP_SERVE")
    if world <= 0:
        logger.warning("control plane env incomplete; staying local")
        return None

    if serve_here:
        served_cap = int(float(knob_env("BFT_CP_MAILBOX_MAX_MB")) * (1 << 20))
        # the shards' replication threads read the native-scope knobs
        # whenever they dial a successor, long after any scoped call has
        # ended: hold the BFT_* values under the library's names for the
        # servers' life (_stop_servers puts the environment back)
        _knobs_saved = export_native_knobs()
        try:
            for _, p in endpoints:
                _servers.append(ControlPlaneServer(
                    world, p, secret=secret, max_mailbox_bytes=served_cap))
        except OSError as exc:
            logger.debug("shard servers not started here (%s)", exc)
            _stop_servers()
        else:
            if len(_servers) > 1 and int(knob_env("BFT_CP_REPLICATION")):
                # each in-process shard streams its WAL to its ring
                # successor, so a key's failover target holds its state
                for i, srv in enumerate(_servers):
                    _, sp = endpoints[(i + 1) % len(endpoints)]
                    srv.set_successor("127.0.0.1", sp, len(endpoints), i)
            # every shard publishes ITS OWN cap, never through the router
            # (whose max-merge would mask a mixed-cap cluster)
            for _, p in endpoints:
                c = ControlPlaneClient("127.0.0.1", p, rank, secret=secret,
                                       streams=1)
                c.put(_MAILBOX_CAP_KEY, served_cap + 1)
                c.close()

    deadline = time.monotonic() + float(knob_env("BFT_CP_CONNECT_TIMEOUT"))
    last: Optional[Exception] = None
    inc = _env_incarnation()
    router = None
    while time.monotonic() < deadline:
        try:
            router = ShardRouter(endpoints, rank, secret=secret,
                                 incarnation=inc)
            break
        except StaleIncarnationError:
            _stop_servers()
            raise
        except OSError as exc:
            last = exc
            time.sleep(0.2)
    names = ",".join(f"{h}:{p}" for h, p in endpoints)
    if router is None:
        _stop_servers()
        if world > 1:
            raise RuntimeError(
                f"control plane connect to shards [{names}] failed after "
                "BFT_CP_CONNECT_TIMEOUT with a declared world of "
                f"{world} processes (rank {rank}): refusing to degrade "
                "a job of several processes to local-only coordination. "
                f"Last error: {last}")
        logger.warning("sharded control plane connect failed (%s); "
                       "staying local", last)
        return None

    # a mixed-cap cluster would truncate deposits on the smaller shards
    # only: fail at attach instead
    caps = {ep: v - 1
            for ep, v in router.replicated_get_all(_MAILBOX_CAP_KEY)
            if v > 0}
    if len(set(caps.values())) > 1:
        router.close()
        _stop_servers()
        raise RuntimeError(
            "control-plane shards advertise DIFFERENT mailbox caps: " +
            ", ".join(f"{ep}={cap}" for ep, cap in sorted(caps.items())) +
            " — set BFT_CP_MAILBOX_MAX_MB identically on every shard "
            "server")

    _client = router
    _world = world
    _conn_params = (None, None, rank, secret)
    _endpoints = list(endpoints)
    _incarnation = inc
    logger.info("control plane attached (sharded): %d shard(s) [%s] "
                "rank=%d world=%d", len(endpoints), names, rank, world)
    return router


def active() -> bool:
    return _client is not None


def client():
    """The process-global client (a ``ControlPlaneClient``, or a
    ``ShardRouter`` over N shards); raises when none is attached."""
    if _client is None:
        raise RuntimeError("control plane is not attached")
    return _client


def extra_client(streams: Optional[int] = None):
    """A NEW dedicated connection to the attached server (the caller closes
    it), for traffic that must not queue behind a blocking op on the
    shared client. ``streams`` overrides the striped pool's width."""
    if _conn_params is None:
        raise RuntimeError("control plane is not attached")
    host, port, rank, secret = _conn_params
    if _endpoints is not None:
        # a router of its own, sharing the main router's dead-shard state
        return ShardRouter(_endpoints, rank, secret=secret, streams=streams,
                           incarnation=_incarnation,
                           shared_state=_client.shared_state())
    return ControlPlaneClient(host, port, rank, secret=secret,
                              streams=streams, incarnation=_incarnation)


def world() -> int:
    return _world


def incarnation() -> int:
    """The incarnation this process registered at attach (0 without a
    control plane)."""
    return _incarnation


def process_index() -> int:
    """This process's controller index: its control-plane rank while one
    is attached, else its rank in the process group (the two agree unless
    ``BFT_CP_RANK`` says otherwise)."""
    if _conn_params is not None:
        return _conn_params[2]
    from .state import _global_state

    st = _global_state()
    return st.rank if st.initialized else 0


def owned_ranks(process_index_: Optional[int] = None) -> List[int]:
    """The ranks whose keys controller ``process_index_`` (default: this
    process) writes: its own rank, one process per rank. Its argument
    makes it the projection of a controller onto its ranks, as JAX's
    ``owned_ranks(devices, pidx)`` is."""
    return [process_index() if process_index_ is None else process_index_]


# Monotone membership-epoch counter: bumped by the SERVER on every
# incarnation registration (join).
_EPOCH_KEY = "bf.membership.epoch"


def membership_epoch_kv() -> int:
    """Raw read of the shared membership-epoch counter (0 when detached)."""
    if _client is None:
        return 0
    try:
        return int(_client.get(_EPOCH_KEY))
    except OSError:
        return 0


def bump_membership_epoch() -> None:
    """Advance the shared membership epoch (best-effort: consumers only
    compare for change)."""
    if _client is not None:
        try:
            _client.fetch_add(_EPOCH_KEY, 1)
        except OSError:
            pass


def detach() -> None:
    """Close the client (and the servers this process owns). Safe to call
    repeatedly."""
    global _client, _server, _tried, _world, _conn_params, _cap_cache, \
        _incarnation, _endpoints
    with _mu:
        if _client is not None:
            _client.close()
            _client = None
        if _server is not None:
            _server.stop()
            _server = None
        _stop_servers()
        _tried = False
        _world = 1
        _conn_params = None
        _endpoints = None
        _cap_cache = None
        _incarnation = 0


def barrier(name: str = "default") -> None:
    if _client is not None:
        _client.barrier(name)


# The serving process's effective per-mailbox byte cap, stored as
# (cap_bytes + 1) so 0 still means "not published".
_MAILBOX_CAP_KEY = "bf.cp.mailbox_cap_bytes"
_cap_cache: Optional[int] = None


def mailbox_cap_bytes() -> int:
    """The server's effective per-mailbox byte cap (0 = unlimited): the
    value the serving process published, else this process's own
    ``BFT_CP_MAILBOX_MAX_MB``. Cached per attachment."""
    global _cap_cache
    if _cap_cache is not None:
        return _cap_cache
    cap = None
    if _client is not None:
        v = _client.get(_MAILBOX_CAP_KEY)
        if v > 0:
            cap = int(v) - 1
    if cap is None:
        cap = int(float(knob_env("BFT_CP_MAILBOX_MAX_MB")) * (1 << 20))
    _cap_cache = cap
    return cap


# -- float scalars over the int64 KV (IEEE754 bit-packing) ------------------

def put_float(cl, key: str, value: float) -> None:
    cl.put(key, struct.unpack("<q", struct.pack("<d", float(value)))[0])


def get_float(cl, key: str) -> float:
    return struct.unpack("<d", struct.pack("<q", cl.get(key)))[0]
