"""Client-side shard router for the sharded control plane.

Counterpart of ``bluefog_tpu/runtime/router.py``: the same placement (the
FNV-1a hash of a key, modulo the shard count), the same replicated key
families and the same failover, so a port client and a JAX client agree
on every key's owner. The sharded deployment runs N server processes
(``python bluefog_tpu_torch/runtime/shard_server.py``, or rank 0 serving N
in-process under ``BFT_CP_SHARDS``), and every client routes each key to
its owning shard with a pure, stable hash: every client in the job agrees
on the owner without coordination.

:class:`ShardRouter` duck-types :class:`ControlPlaneClient` and adds:

* **Replication** of the membership-critical scalar keys (the membership
  epoch, per-rank incarnation mirrors, quarantine phases, shutdown flags,
  and the control plane's own ``bf.cp.*`` keys). Writes fan out to EVERY
  live shard through the monotone ``put_max`` merge (commutative and
  idempotent, so failover reordering can never regress a value) and reads
  take the max across live shards: a shard SIGKILL cannot lose membership
  state. Incarnation registration (``kAttach``) is inherently replicated:
  each per-shard connection registers with every shard.

* **Failover**: when a shard stops answering (its native client exhausted
  its redial budget), the router marks it dead, publishes a generation
  under ``bf.cp.shard_dead.<i>`` (odd = dead, even = rejoined) to the
  survivors so every other process converges on the same routing, and
  re-routes the dead shard's keyspace to the next live shard on the ring.
  Each per-shard native client carries its ring successor as a failover
  redirect target: a call in flight when the shard dies redials the
  successor on the same client, with the same kSeqPre (cid, seq) identity,
  so on a WAL-replicated pair the successor replays the recorded reply
  instead of applying it twice.

* **Rejoin**: a restarted shard server that caught up from its
  successor's snapshot and WAL publishes an EVEN generation under its
  ``bf.cp.shard_dead.<i>`` key (and its endpoint under
  ``bf.cp.shard_addr.<i>``); routers observe it on the next health poll,
  dial the endpoint fresh, and move the keyspace back.

With ``BFT_CP_REPLICATION=0`` routed state on a killed shard is lost with
it, and locks held there surface PeerLostError instead of handing off.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, List, Optional, Sequence, Tuple

from .config import knob_env
from .logging import logger
from .native import (ControlPlaneClient, PeerLostError,  # noqa: F401
                     QuorumLostError, StaleIncarnationError, _MultiReply)

# Scalar key families replicated on every shard (writes via put_max
# fan-out, reads as max over live shards). All are monotone by protocol:
# the epoch and incarnations only grow, quarantine phases go 1 -> 2 under
# per-(rank, incarnation) keys, shutdown flags/acks go 0 -> 1, and the
# bf.cp.* config/health keys (mailbox cap, shard-dead flags) are
# write-once / latching.
_REPL_EXACT = frozenset({"bf.membership.epoch"})
_REPL_PREFIX = ("bf.inc.", "bf.q.", "bf.shutdown.", "bf.cp.")

# Per-shard liveness GENERATION (monotone, merged with put_max): 0 = never
# died, odd = dead, even (> 0) = rejoined. A router declaring a death bumps
# an even value to the next odd one; a rejoined shard server publishes the
# next even value after its snapshot catch-up. Monotone merge keeps the
# transitions race-free under failover reordering (a late duplicate can
# never flip a rejoined shard back to dead).
_DEAD_FLAG = "bf.cp.shard_dead.{idx}"


def _gen_dead(gen: int) -> bool:
    return gen > 0 and gen % 2 == 1


# Published rejoin address: a shard server restarted SOMEWHERE ELSE
# publishes its new endpoint here, generation-stamped so the monotone
# put_max merge can never regress to a stale address. The key rides the ``bf.cp.`` replicated
# family, so any live shard can answer for it.
SHARD_ADDR_FMT = "bf.cp.shard_addr.{idx}"


def pack_shard_addr(gen: int, host: str, port: int) -> int:
    """``(gen << 48) | (ipv4 << 16) | port`` — monotone in the liveness
    generation, self-describing on decode. Hostname operands resolve to
    IPv4 here (the wire carries only the packed form)."""
    try:
        ip = struct.unpack("!I", socket.inet_aton(host))[0]
    except OSError:
        ip = struct.unpack(
            "!I", socket.inet_aton(socket.gethostbyname(host)))[0]
    return ((int(gen) & 0xFFFF) << 48) | (ip << 16) | (int(port) & 0xFFFF)


def unpack_shard_addr(value: int) -> Optional[Tuple[int, str, int]]:
    """Packed rejoin address -> (generation, host, port); None for the
    never-published (<= 0) value."""
    value = int(value)
    if value <= 0:
        return None
    host = socket.inet_ntoa(struct.pack("!I", (value >> 16) & 0xFFFFFFFF))
    return (value >> 48) & 0xFFFF, host, value & 0xFFFF

# Endpoints whose death was already ERROR-announced by THIS process: many
# routers (one per subsystem) detect the same death
# within milliseconds, and one loud line per process is signal while N
# identical ones are noise. Guarded by the GIL (set.add is atomic enough
# for a log-dedup). _announced_alive dedups the matching REJOIN line per
# liveness generation.
_announced_dead: set = set()
_announced_alive: set = set()

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3


def _fnv64(key: str) -> int:
    h = _FNV_OFFSET
    for b in key.encode():
        h ^= b
        h = (h * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def is_replicated_key(key: str) -> bool:
    return key in _REPL_EXACT or key.startswith(_REPL_PREFIX)


def parse_endpoints(spec: str) -> List[Tuple[str, int]]:
    """``host:port[,host:port...]`` -> [(host, port)] (the
    ``BFT_CP_HOSTS`` grammar). Raises ValueError on a malformed entry."""
    out: List[Tuple[str, int]] = []
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        host, sep, port = item.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"control-plane endpoint {item!r}: want HOST:PORT")
        out.append((host, int(port)))
    return out


class _ShardState:
    """Dead-set shared by every router of one attachment (the main client
    and heartbeat/subsystem extra clients must agree on routing)."""

    def __init__(self, endpoints: Sequence[Tuple[str, int]]) -> None:
        self.endpoints = list(endpoints)
        self.dead: set = set()
        self.mu = threading.Lock()


class _NullReply:
    """Empty drain owner (zero-key take_bytes_many_views)."""

    view = memoryview(b"")

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ShardRouter:
    """N-shard control-plane client: consistent routing + failover.

    Duck-types :class:`ControlPlaneClient`. ``lenient=True`` (status/dump
    tooling) tolerates shards that are already unreachable at construction
    — they are marked dead and reported by name instead of raising. The
    default (job attach) is stricter but failover-aware: an unreachable
    shard is accepted only when the SURVIVORS have flagged it dead
    (``bf.cp.shard_dead.<i>`` — a respawned rank must be able to rejoin a
    legitimately degraded cluster), while a fresh job with a down,
    unflagged shard fails loudly — it would otherwise silently run with
    less replication than the operator configured.
    """

    def __init__(self, endpoints: Sequence[Tuple[str, int]], rank: int,
                 secret: str = "", streams: Optional[int] = None,
                 incarnation: Optional[int] = None,
                 shared_state: Optional[_ShardState] = None,
                 lenient: bool = False) -> None:
        if not endpoints:
            raise ValueError("ShardRouter needs at least one endpoint")
        self._st = shared_state or _ShardState(endpoints)
        self._rank = rank
        self._secret = secret
        self._streams = streams
        self.incarnation = None if incarnation is None else int(incarnation)
        self._clients: List[Optional[ControlPlaneClient]] = []
        # Clients superseded by a shard rejoin are parked here (closed at
        # router close): another thread may still be mid-call on one, and
        # closing a native client under a live call is a use-after-free.
        self._zombies: List[ControlPlaneClient] = []
        unreachable: List[int] = []

        def _bail(exc: Optional[Exception] = None):
            for cl in self._clients:
                if cl is not None:
                    cl.close()
            if exc is not None:
                raise exc

        for idx, (host, port) in enumerate(self._st.endpoints):
            if idx in self._st.dead:
                self._clients.append(None)
                continue
            try:
                self._clients.append(self._dial(idx))
            except StaleIncarnationError:
                _bail()
                raise
            except OSError:
                self._clients.append(None)
                unreachable.append(idx)
        if unreachable and not lenient:
            # failover-aware strictness: accept an unreachable shard only
            # when a survivor has flagged it dead (a rejoin into a
            # legitimately degraded cluster); otherwise raise — a FRESH
            # job must not start with less replication than configured
            flags = None
            for cl in self._clients:
                if cl is None:
                    continue
                try:
                    flags = cl.get_many(
                        [_DEAD_FLAG.format(idx=i) for i in unreachable])
                    break
                except OSError:
                    continue
            if flags is None or not all(_gen_dead(f) for f in flags):
                bad = [i for i in unreachable] if flags is None else \
                    [i for i, f in zip(unreachable, flags)
                     if not _gen_dead(f)]
                names = ", ".join(
                    "%s:%d" % self._st.endpoints[i] for i in bad)
                _bail(OSError(
                    f"control-plane shard(s) {names} unreachable and not "
                    "flagged dead by any survivor — refusing to attach a "
                    "job with less replication than configured (a shard "
                    "that legitimately died mid-job is announced under "
                    "bf.cp.shard_dead.<i> and tolerated)"))
        for idx in unreachable:  # after the list is complete: _mark_dead
            self._mark_dead(idx, "unreachable at attach")  # walks it
        if all(cl is None for cl in self._clients):
            raise OSError(
                "no control-plane shard reachable: "
                + ", ".join(f"{h}:{p}" for h, p in self._st.endpoints))
        self.streams = max(cl.streams for cl in self._clients
                           if cl is not None)

    def _dial(self, idx: int) -> ControlPlaneClient:
        """A fresh connection to shard ``idx``, armed with its ring
        successor(s) as the native failover-redirect targets (N > 1): an
        op in flight when the shard dies redials the successor on the
        SAME client — preserving the kSeqPre identity the successor's
        WAL-primed dedup table replays against. At quorum replication
        (R >= 3) the redirect is a CHAIN of the R-1 ring successors in
        walk order, so a run of consecutive dead shards (up to R-1 of
        them — a shard AND its successor dying together) still lands on
        a replica holding the keyspace."""
        host, port = self._st.endpoints[idx]
        cl = ControlPlaneClient(host, port, self._rank, secret=self._secret,
                                streams=self._streams,
                                incarnation=self.incarnation)
        n = len(self._st.endpoints)
        if n > 1:
            r = int(knob_env("BFT_CP_REPLICATION"))
            hops = min(r - 1, n - 1) if r >= 3 else 1
            if hops > 1:
                cl.set_failover_chain(
                    [self._st.endpoints[(idx + k) % n]
                     for k in range(1, hops + 1)])
            else:  # R <= 2: the chain wire, single-successor redirect
                cl.set_failover(*self._st.endpoints[(idx + 1) % n])
        return cl

    # -- topology ----------------------------------------------------------

    @property
    def endpoints(self) -> List[Tuple[str, int]]:
        return list(self._st.endpoints)

    @property
    def shard_count(self) -> int:
        return len(self._st.endpoints)

    def shared_state(self) -> _ShardState:
        return self._st

    def dead_shards(self) -> set:
        with self._st.mu:
            return set(self._st.dead)

    def dead_shard_endpoints(self) -> List[str]:
        return [f"{h}:{p}" for i, (h, p) in enumerate(self._st.endpoints)
                if i in self.dead_shards()]

    def shard_of(self, key: str) -> int:
        """The key's PREFERRED shard (ignoring liveness): the pure hash
        every client in the job agrees on."""
        return _fnv64(key) % len(self._st.endpoints)

    def owner_of(self, key: str) -> int:
        """The key's CURRENT owner (the first live shard on its ring) —
        what an exactly-once oracle across failover eras keys off."""
        return self._route(key)

    def _route(self, key: str) -> int:
        """The key's current owner: the first LIVE shard on its ring."""
        n = len(self._st.endpoints)
        pref = _fnv64(key) % n
        for attempt in range(2):
            with self._st.mu:
                for k in range(n):
                    idx = (pref + k) % n
                    if idx not in self._st.dead and \
                            self._clients[idx] is not None:
                        return idx
            # Last-chance probe before declaring the whole plane gone: a
            # shard may have REJOINED since this router last looked (its
            # even liveness generation is on the ring, but a router that
            # was blocked through the entire failover era — or adopted a
            # peer's flag just as the peer's shard was already
            # restarting — only polls health later, and with every shard
            # flagged dead there is no live client left to poll THROUGH).
            # A fresh dial per endpoint decides; anything that answers
            # rejoins the routing table.
            if attempt == 0 and not self._recover_all_dead():
                break
        raise OSError(
            "all control-plane shards are dead: "
            + ", ".join(f"{h}:{p}" for h, p in self._st.endpoints))

    def _recover_all_dead(self) -> bool:
        """Every shard is flagged dead: re-dial each endpoint once and
        adopt any that actually serves (``_mark_alive`` re-verifies under
        the shared state lock). Returns True when at least one shard came
        back. Genuinely dead endpoints refuse the dial fast, so the probe
        costs one connect attempt per shard on an already-fatal path."""
        for idx in range(len(self._st.endpoints)):
            self._mark_alive(idx, "all-dead recovery probe")
        return len(self.dead_shards()) < len(self._st.endpoints)

    def _live(self) -> List[int]:
        with self._st.mu:
            return [i for i in range(len(self._st.endpoints))
                    if i not in self._st.dead
                    and self._clients[i] is not None]

    def _mark_dead(self, idx: int, why) -> None:
        with self._st.mu:
            if idx in self._st.dead:
                return
            self._st.dead.add(idx)
            dead_n = len(self._st.dead)
        n = len(self._st.endpoints)
        host, port = self._st.endpoints[idx]
        succ = (idx + 1) % n
        first = (host, port) not in _announced_dead
        _announced_dead.add((host, port))
        (logger.error if first else logger.debug)(
            "control-plane shard %d (%s:%d) declared DEAD (%s); its "
            "keyspace fails over to shard %d, the next live shard on the "
            "ring — with WAL replication the successor already holds its "
            "mailbox/KV/lock state (zero lost deposits); unreplicated "
            "(BFT_CP_REPLICATION=0) routed state is lost with it", idx, host, port, why, succ)
        try:  # lazy: metrics -> control_plane -> router would be circular
            from . import metrics as _metrics

            _metrics.counter("cp.shard_failovers").inc()
            _metrics.counter("cp.shard_promotions").inc()
            _metrics.gauge("cp.dead_shards").set(dead_n)
        except Exception:  # noqa: BLE001 — telemetry must not mask failover
            pass
        try:
            from . import flight as _flight

            _flight.recorder().instant("cp.shard_dead", a=float(idx))
            _flight.recorder().instant("cp.shard_promoted", a=float(succ))
        except Exception:  # noqa: BLE001
            pass
        # Tell every other process (best-effort): their routers adopt the
        # flag on the next heartbeat tick, so the job converges on one
        # routing instead of split-braining on per-process detection. The
        # flag is a GENERATION: bump the current (even/0) value to the
        # next odd one; monotone put_max makes concurrent announcers
        # converge on the same generation.
        flag = _DEAD_FLAG.format(idx=idx)
        for j in self._live():
            try:
                cur = self._clients[j].put_max(flag, 0)
                if cur >= 0 and not _gen_dead(cur):
                    self._clients[j].put_max(flag, cur + 1)
            except (OSError, RuntimeError):
                pass

    def _adopt_published_addr(self, idx: int) -> None:
        """A shard that rejoined on a NEW host:port published it under
        ``bf.cp.shard_addr.<idx>`` (generation-stamped, put_max-merged).
        Take the max across live shards and re-point the shared endpoint
        table before dialing — otherwise the rejoin dial would hit the
        dead old endpoint forever."""
        key = SHARD_ADDR_FMT.format(idx=idx)
        best = 0
        for j in self._live():
            cl = self._clients[j]
            if cl is None:
                continue
            try:
                best = max(best, int(cl.get(key)))
            except (OSError, RuntimeError):
                continue
        dec = unpack_shard_addr(best)
        if dec is None:
            return
        _gen, host, port = dec
        with self._st.mu:
            old = tuple(self._st.endpoints[idx])
            if (host, port) == old:
                return
            self._st.endpoints[idx] = (host, port)
        logger.warning(
            "control-plane shard %d moved: %s:%d -> %s:%d (published "
            "rejoin address adopted; generation %d)", idx, old[0], old[1],
            host, port, _gen)

    def _mark_alive(self, idx: int, why) -> None:
        """Shard rejoin (even liveness generation observed): dial the
        endpoint fresh and move its keyspace back. The superseded client
        (possibly failover-redirected) is parked, never closed mid-call."""
        with self._st.mu:
            if idx not in self._st.dead:
                return
        self._adopt_published_addr(idx)
        try:
            cl = self._dial(idx)
        except (OSError, RuntimeError):
            return  # not actually serving yet; retried on the next poll
        except StaleIncarnationError:
            return  # a newer incarnation of this rank owns the identity
        adopted = False
        with self._st.mu:
            if idx in self._st.dead:
                self._st.dead.discard(idx)
                adopted = True
                dead_n = len(self._st.dead)
        if not adopted:
            cl.close()
            return
        old, self._clients[idx] = self._clients[idx], cl
        if old is not None:
            self._zombies.append(old)
        host, port = self._st.endpoints[idx]
        _announced_dead.discard((host, port))
        first = (host, port, why) not in _announced_alive
        _announced_alive.add((host, port, why))
        (logger.warning if first else logger.debug)(
            "control-plane shard %d (%s:%d) REJOINED (%s): snapshot "
            "catch-up complete, keyspace routing restored", idx, host,
            port, why)
        try:
            from . import metrics as _metrics

            _metrics.counter("cp.shard_rejoins").inc()
            _metrics.gauge("cp.dead_shards").set(dead_n)
        except Exception:  # noqa: BLE001
            pass
        try:
            from . import flight as _flight

            _flight.recorder().instant("cp.shard_rejoin", a=float(idx))
        except Exception:  # noqa: BLE001
            pass

    def _check_failed_over(self, idx: int) -> None:
        """After a successful call on shard ``idx``'s client: if the
        native layer permanently redirected it to the ring successor, the
        primary endpoint is PROBABLY dead — but the redirect may also be
        stale (the shard has since rejoined) or spurious (a connect-storm
        dial failure on a live shard). A fresh dial to the true endpoint
        decides: success swaps the redirected client out (self-heal,
        no death published — publishing one would wedge the ring dead
        with a new odd generation nobody re-evens); failure declares the
        death for the whole job."""
        cl = self._clients[idx]
        if cl is None or idx in self._st.dead or not cl.failed_over():
            return
        try:
            fresh = self._dial(idx)
        except (OSError, RuntimeError):
            self._mark_dead(idx, "native failover redirect engaged")
            return
        except StaleIncarnationError:
            self._mark_dead(idx, "native failover redirect engaged")
            return
        self._zombies.append(cl)
        self._clients[idx] = fresh

    def poll_shard_health(self) -> set:
        """Heartbeat-tick probe: adopt peer-published liveness
        generations (odd = dead, even = rejoined), verify each live shard
        still answers, and notice clients whose calls silently redirected
        to the ring successor. Returns the dead set."""
        n = len(self._st.endpoints)
        keys = [_DEAD_FLAG.format(idx=i) for i in range(n)]
        gens: dict = {}
        for idx in self._live():
            cl = self._clients[idx]
            try:
                flags = cl.get_many(keys)
            except OSError as exc:
                self._mark_dead(idx, exc)
                continue
            self._check_failed_over(idx)
            for i, f in enumerate(flags):
                gens[i] = max(gens.get(i, 0), int(f))
        for i, g in sorted(gens.items()):
            if _gen_dead(g):
                self._mark_dead(i, "peer-published failover flag")
            elif g > 0 and i in self.dead_shards():
                self._mark_alive(i, f"liveness generation {g}")
        return self.dead_shards()

    # -- failover plumbing -------------------------------------------------

    def _on_key(self, key: str, fn: Callable):
        """Run ``fn(client)`` on the key's owner, failing over along the
        ring on wire death. Typed errors (StaleIncarnationError,
        PeerLostError, mailbox-full RuntimeError) propagate — failover is
        only for a shard that stopped answering."""
        last: Optional[Exception] = None
        for _ in range(len(self._st.endpoints)):
            idx = self._route(key)
            try:
                out = fn(self._clients[idx])
            except OSError as exc:
                self._mark_dead(idx, exc)
                last = exc
                continue
            # a call that succeeded by silently redirecting to the ring
            # successor proves the primary dead — record it so routing
            # (and every peer, via the published flag) converges now
            # instead of at the next heartbeat tick
            self._check_failed_over(idx)
            return out
        raise OSError(f"all control-plane shards failed for {key!r}: {last}")

    def _routed_batch(self, names: Sequence[str], call: Callable) -> list:
        """Partition ``names`` by owning shard, run ``call(client,
        positions)`` per shard (which must return one result per
        position), scatter results back in order; sub-batches on a shard
        that dies mid-call re-route through the shrunken ring."""
        names = list(names)
        out = [None] * len(names)
        pending = list(range(len(names)))
        while pending:
            groups: dict = {}
            for i in pending:
                groups.setdefault(self._route(names[i]), []).append(i)
            pending = []
            for sidx, idxs in groups.items():
                try:
                    res = call(self._clients[sidx], idxs)
                except OSError as exc:
                    self._mark_dead(sidx, exc)
                    pending.extend(idxs)
                    continue
                self._check_failed_over(sidx)
                for i, r in zip(idxs, res):
                    out[i] = r
        return out

    # -- replicated scalar class -------------------------------------------

    # NOTE on failure detection: the native scalar ``get``/``fetch_add``/
    # ``put_max`` report a wire failure IN-BAND as -1 (a scalar reply
    # cannot carry a side channel), so the router reaches shard-death
    # detection by riding the pipelined ``*_many`` paths for scalar reads
    # and RMWs — those raise OSError on a dead connection — and by
    # checking ``put_max`` results explicitly (replicated values are
    # non-negative by protocol, so a -1 there IS the wire failure).

    def _repl_write(self, key: str, value: int) -> None:
        """Fan a monotone write to every live shard (>= 1 must ack).

        A shard that answers with the quorum-lost rejection is ALIVE but
        on the minority side of a partition — skipping it (never marking
        it dead: its keyspace must not fail over while the process
        serves reads) keeps membership writes flowing through the
        majority side. Only when EVERY live shard is below quorum does
        the typed error propagate — the writer itself is then on the
        minority side."""
        ok = 0
        qlost: Optional[QuorumLostError] = None
        for idx in self._live():
            try:
                if self._clients[idx].put_max(key, int(value)) < 0:
                    raise OSError(
                        f"shard {idx}: put_max wire failure")
                ok += 1
            except QuorumLostError as exc:
                qlost = exc
            except OSError as exc:
                self._mark_dead(idx, exc)
        if not ok:
            if qlost is not None:
                raise qlost
            raise OSError(f"replicated write of {key!r}: no live shard")

    def _repl_read(self, key: str) -> int:
        """Max over live shards (each shard's copy is monotone; max is the
        merge that cannot regress after a failover)."""
        best: Optional[int] = None
        for idx in self._live():
            try:
                v = int(self._clients[idx].get_many([key])[0])
            except OSError as exc:
                self._mark_dead(idx, exc)
                continue
            best = v if best is None else max(best, v)
        if best is None:
            raise OSError(f"replicated read of {key!r}: no live shard")
        return best

    def replicated_get_all(self, key: str) -> List[Tuple[str, int]]:
        """(endpoint, value) per LIVE shard — the attach-time agreement
        check for bf.cp.mailbox_cap_bytes reads every copy."""
        out = []
        for idx in self._live():
            h, p = self._st.endpoints[idx]
            try:
                out.append((f"{h}:{p}",
                            int(self._clients[idx].get_many([key])[0])))
            except OSError as exc:
                self._mark_dead(idx, exc)
        return out

    # -- scalar ops --------------------------------------------------------

    def barrier(self, name: str = "default") -> int:
        return self._on_key(name, lambda cl: cl.barrier(name))

    def lock(self, name: str) -> None:
        return self._on_key(name, lambda cl: cl.lock(name))

    def unlock(self, name: str) -> None:
        return self._on_key(name, lambda cl: cl.unlock(name))

    def fetch_add(self, name: str, delta: int = 1) -> int:
        if is_replicated_key(name):
            # every live copy advances; the max pre-value preserves the
            # only contract consumers rely on (monotone, moves on change).
            # Quorum-lost shards are skipped alive (see _repl_write).
            pre: Optional[int] = None
            qlost: Optional[QuorumLostError] = None
            for idx in self._live():
                try:
                    v = int(self._clients[idx].fetch_add_many(
                        [name], deltas=[delta])[0])
                except QuorumLostError as exc:
                    qlost = exc
                    continue
                except OSError as exc:
                    self._mark_dead(idx, exc)
                    continue
                pre = v if pre is None else max(pre, v)
            if pre is None:
                if qlost is not None:
                    raise qlost
                raise OSError(f"replicated fetch_add of {name!r}: no live "
                              "shard")
            return pre
        return self._on_key(
            name, lambda cl: cl.fetch_add_many([name], deltas=[delta])[0])

    def put(self, name: str, value: int) -> None:
        if is_replicated_key(name):
            self._repl_write(name, value)
            return
        return self._on_key(name, lambda cl: cl.put(name, value))

    def put_max(self, name: str, value: int) -> int:
        if is_replicated_key(name):
            self._repl_write(name, value)
            return int(value)

        def one(cl):
            r = cl.put_max(name, value)
            if r == -1:  # in-band wire failure (see NOTE above)
                raise OSError("put_max wire failure")
            return r

        return self._on_key(name, one)

    def get(self, name: str) -> int:
        if is_replicated_key(name):
            return self._repl_read(name)
        return self._on_key(name, lambda cl: cl.get_many([name])[0])

    # -- pipelined scalar batches ------------------------------------------

    def _split_replicated(self, names: Sequence[str]):
        names = list(names)
        repl = [i for i, nm in enumerate(names) if is_replicated_key(nm)]
        routed = [i for i, nm in enumerate(names)
                  if not is_replicated_key(nm)]
        return names, repl, routed

    def get_many(self, names) -> list:
        names, repl, routed = self._split_replicated(names)
        if not names:
            return []
        out = [0] * len(names)
        for i in repl:
            out[i] = self._repl_read(names[i])
        if routed:
            sub = self._routed_batch(
                [names[i] for i in routed],
                lambda cl, idxs: cl.get_many(
                    [names[routed[j]] for j in idxs]))
            for j, i in enumerate(routed):
                out[i] = sub[j]
        return out

    def put_many(self, names, values) -> None:
        names = list(names)
        values = list(values)
        if not names:
            return
        repl = [i for i, nm in enumerate(names) if is_replicated_key(nm)]
        for i in repl:
            self._repl_write(names[i], values[i])
        routed = [i for i in range(len(names)) if i not in set(repl)]
        if routed:
            self._routed_batch(
                [names[i] for i in routed],
                lambda cl, idxs: cl.put_many(
                    [names[routed[j]] for j in idxs],
                    [values[routed[j]] for j in idxs]) or
                [None] * len(idxs))

    def fetch_add_many(self, names, deltas=None) -> list:
        names = list(names)
        if not names:
            return []
        deltas = [1] * len(names) if deltas is None else list(deltas)
        out = [0] * len(names)
        repl = [i for i, nm in enumerate(names) if is_replicated_key(nm)]
        for i in repl:
            out[i] = self.fetch_add(names[i], deltas[i])
        routed = [i for i in range(len(names)) if i not in set(repl)]
        if routed:
            sub = self._routed_batch(
                [names[i] for i in routed],
                lambda cl, idxs: cl.fetch_add_many(
                    [names[routed[j]] for j in idxs],
                    deltas=[deltas[routed[j]] for j in idxs]))
            for j, i in enumerate(routed):
                out[i] = sub[j]
        return out

    # -- bulk bytes (mailboxes / bytes slots are never replicated) ---------

    def append_bytes(self, name: str, data) -> int:
        return self._on_key(name, lambda cl: cl.append_bytes(name, data))

    def take_bytes(self, name: str) -> list:
        return self._on_key(name, lambda cl: cl.take_bytes(name))

    def put_bytes(self, name: str, data) -> None:
        return self._on_key(name, lambda cl: cl.put_bytes(name, data))

    def get_bytes(self, name: str) -> bytes:
        return self._on_key(name, lambda cl: cl.get_bytes(name))

    def bytes_len(self, name: str) -> int:
        return self._on_key(name, lambda cl: cl.bytes_len(name))

    def get_bytes_view(self, name: str):
        return self._on_key(name, lambda cl: cl.get_bytes_view(name))

    def append_bytes_many(self, names, blobs) -> list:
        names = list(names)
        blobs = list(blobs)
        return self._routed_batch(
            names,
            lambda cl, idxs: cl.append_bytes_many(
                [names[i] for i in idxs], [blobs[i] for i in idxs]))

    def append_bytes_tagged_many(self, names, blobs, tags) -> list:
        names, blobs, tags = list(names), list(blobs), list(tags)
        # per-shard sub-batches preserve the header-before-chunks arrival
        # order per mailbox key (one key never splits across shards)
        return self._routed_batch(
            names,
            lambda cl, idxs: cl.append_bytes_tagged_many(
                [names[i] for i in idxs], [blobs[i] for i in idxs],
                [tags[i] for i in idxs]))

    def put_bytes_many(self, names, blobs) -> None:
        names = list(names)
        blobs = list(blobs)
        self._routed_batch(
            names,
            lambda cl, idxs: cl.put_bytes_many(
                [names[i] for i in idxs], [blobs[i] for i in idxs]) or
            [None] * len(idxs))

    def take_bytes_many(self, names) -> list:
        names = list(names)
        return self._routed_batch(
            names,
            lambda cl, idxs: cl.take_bytes_many([names[i] for i in idxs]))

    def box_bytes_many(self, names) -> list:
        names = list(names)
        return self._routed_batch(
            names,
            lambda cl, idxs: cl.box_bytes_many([names[i] for i in idxs]))

    def get_bytes_many(self, names) -> list:
        names = list(names)
        return self._routed_batch(
            names,
            lambda cl, idxs: cl.get_bytes_many([names[i] for i in idxs]))

    def take_bytes_many_views(self, names, pooled: bool = True):
        names = list(names)
        if not names:
            return [], _NullReply()
        out = [None] * len(names)
        owners = []
        pending = list(range(len(names)))
        while pending:
            groups: dict = {}
            for i in pending:
                groups.setdefault(self._route(names[i]), []).append(i)
            pending = []
            for sidx, idxs in groups.items():
                try:
                    recs, owner = self._clients[sidx].take_bytes_many_views(
                        [names[i] for i in idxs], pooled=pooled)
                except OSError as exc:
                    self._mark_dead(sidx, exc)
                    pending.extend(idxs)
                    continue
                self._check_failed_over(sidx)
                owners.append(owner)
                for i, r in zip(idxs, recs):
                    out[i] = r
        return out, _MultiReply(owners)

    # -- per-shard introspection -------------------------------------------

    def server_stats_all(self) -> List[Tuple[str, Optional[dict]]]:
        """(endpoint, counter block or None-when-dead) per shard — the
        merged per-shard view of a status reader."""
        out: List[Tuple[str, Optional[dict]]] = []
        for idx, (h, p) in enumerate(self._st.endpoints):
            name = f"{h}:{p}"
            if idx in self.dead_shards() or self._clients[idx] is None:
                out.append((name, None))
                continue
            try:
                out.append((name, self._clients[idx].server_stats()))
            except OSError as exc:
                self._mark_dead(idx, exc)
                out.append((name, None))
        return out

    def close(self) -> None:
        for cl in self._clients:
            if cl is not None:
                cl.close()
        self._clients = [None] * len(self._clients)
        for cl in self._zombies:
            cl.close()
        self._zombies = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
