"""One control-plane shard server, as a standalone OS process.

Counterpart of ``bluefog_tpu/runtime/shard_server.py``. The sharded
control plane runs N of these; clients route keys across them with
:class:`bluefog_tpu_torch.runtime.router.ShardRouter`:

    python bluefog_tpu_torch/runtime/shard_server.py --port P --world W [--shard I]

Run BY FILE PATH it bootstraps lean: the relative imports below resolve
without executing ``bluefog_tpu_torch/__init__`` (which imports torch), so
a shard server starts in a fraction of a second, holds no device state,
and runs where torch cannot even be imported.

Prints ``BF_SHARD_READY <port>`` on stdout once serving (the spawner's
readiness handshake), then blocks until SIGTERM/SIGINT. The job secret
rides ``BFT_CP_SECRET``, and the server self-publishes its effective
mailbox cap under ``bf.cp.mailbox_cap_bytes`` so attach-time agreement
checks can reject a mixed-cap cluster (every shard publishes its OWN
value; a router never writes this key).

Replication wiring: with ``--expect-peers`` the handshake is two-phase:
the server prints ``BF_SHARD_PORT <port>`` first, the spawner collects
every shard's port and writes one ``BF_SHARD_PEERS host:port,...`` line to
each shard's stdin, and only then does the server configure its ring
successor (WAL replication, ``BFT_CP_REPLICATION``) and print the READY
line, so ephemeral ports (``--port 0``) need no port plan. ``--rejoin``
pulls a state snapshot from the ring successor, loads it, publishes the
next EVEN liveness generation under ``bf.cp.shard_dead.<i>`` so every
router moves the keyspace back, and publishes its current endpoint under
``bf.cp.shard_addr.<i>``. (The ring predecessor's WAL stream stays pinned
to a moved shard's old endpoint until the ring is restarted.)

The native library reads its own knobs (lock lease, barrier deadline,
retries, replication timeout and depth) under their native names, some of
them from replication threads outside any call: this process exports the
``BFT_*`` values under those names for its whole life.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__" and __package__ in (None, ""):
    # Lean bootstrap: register dummy parent packages so the relative
    # imports below resolve WITHOUT executing bluefog_tpu_torch/__init__
    # (torch).
    import types

    _here = os.path.dirname(os.path.abspath(__file__))
    _pkg = os.path.dirname(_here)
    # replace sys.path[0] (this script's directory — it would shadow the
    # stdlib `logging` with runtime/logging.py) with the repo root
    sys.path[0] = os.path.dirname(_pkg)
    for _name, _path in (("bluefog_tpu_torch", _pkg),
                         ("bluefog_tpu_torch.runtime", _here)):
        if _name not in sys.modules:
            _mod = types.ModuleType(_name)
            _mod.__path__ = [_path]
            sys.modules[_name] = _mod
    __package__ = "bluefog_tpu_torch.runtime"

import argparse
import signal
import threading
import time

from .config import knob_env
from .logging import logger
from .native import (ControlPlaneClient, ControlPlaneServer,
                     export_native_knobs)

READY_MARKER = "BF_SHARD_READY"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bf-shard-server",
        description="Serve one shard of the bluefog control plane.")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port to bind (0 = ephemeral, reported on the "
                        "READY line)")
    p.add_argument("--world", type=int, default=1,
                   help="number of controller processes in the job "
                        "(barrier arity; must match every shard)")
    p.add_argument("--shard", type=int, default=0,
                   help="this shard's index (logging only; routing is "
                        "decided client-side by key hash)")
    p.add_argument("--mailbox-max-mb", type=float, default=None,
                   help="per-mailbox byte cap (default: the "
                        "BFT_CP_MAILBOX_MAX_MB registry knob)")
    p.add_argument("--expect-peers", action="store_true",
                   help="two-phase start: print BF_SHARD_PORT, read one "
                        "'BF_SHARD_PEERS host:port,...' line from stdin, "
                        "wire the ring successor (WAL replication), then "
                        "print the READY line")
    p.add_argument("--peers", default=None, metavar="HOST:PORT,...",
                   help="explicit ring endpoint list (all shards, in "
                        "index order) when ports are known up front; "
                        "alternative to --expect-peers")
    p.add_argument("--rejoin", action="store_true",
                   help="restarted-shard catch-up: pull a state snapshot "
                        "from the ring successor, load it, and publish "
                        "the next even liveness generation plus this "
                        "server's current endpoint (bf.cp.shard_addr.<i>) "
                        "before READY (requires a peer list; a new port — "
                        "--port 0 included — is fine, routers re-dial it)")
    p.add_argument("--advertise-host", default=None,
                   help="host routers should re-dial after a rejoin "
                        "(default: this shard's entry in the peer list)")
    return p


def _parse_peers(spec: str):
    out = []
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        host, _, port = item.rpartition(":")
        out.append((host, int(port)))
    return out


def _successor_count(nshards: int) -> int:
    """How many ring successors this shard streams its WAL to.

    ``BFT_CP_REPLICATION`` counts COPIES: 0 disables replication,
    1 is the on-switch (aliases the two-copy chain), R >= 2 keeps R
    copies of every record — the primary plus min(R, nshards)-1
    successor streams. R=2 therefore stays byte-identical to the chain
    wire; R >= 3 arms quorum mode (commit = ack-from-majority)."""
    r = int(knob_env("BFT_CP_REPLICATION"))
    if r <= 0 or nshards < 2:
        return 0
    copies = 2 if r == 1 else min(r, nshards)
    return copies - 1


def _arm_partition_from_env(peers, shard_idx: int) -> None:
    """Arm the deterministic partition injector from ``BFT_CP_FAULT``
    (``partition=0,1|2,3[,part_after=S][,heal_after=S]``). The grammar
    names SHARD INDICES; only here — where the peer list pins each index
    to a port — can they resolve to the port->group map the native cut
    enforces at the client socket layer. The server's own replicator and
    rejoin clients inherit this side of the cut, so a minority shard
    loses its commit quorum exactly as a real switch split would."""
    from . import native as _native

    try:
        spec = _native.parse_fault_spec(knob_env("BFT_CP_FAULT") or "")
    except ValueError as exc:
        logger.warning("shard %d: bad BFT_CP_FAULT partition spec "
                       "(%s); injector not armed", shard_idx, exc)
        return
    groups = spec.get("partition")
    if not groups:
        return
    port_groups = {}
    self_group = -1
    for g, members in enumerate(groups):
        for m in members:
            if 0 <= m < len(peers):
                port_groups[peers[m][1]] = g
            if m == shard_idx:
                self_group = g
    _native.partition_arm(port_groups, self_group,
                          start_after=float(spec.get("part_after", 0.0)),
                          heal_after=float(spec.get("heal_after", 0.0)))
    logger.warning("shard %d: partition injector armed (side %d of %s, "
                   "part_after=%.3gs heal_after=%.3gs)", shard_idx,
                   self_group, groups, spec.get("part_after", 0.0),
                   spec.get("heal_after", 0.0))


def _published_addr(peers, idx: int, secret: str, skip: int = -1):
    """Best-effort: shard ``idx``'s CURRENT endpoint per the replicated
    ``bf.cp.shard_addr.<idx>`` key (None when never moved / no peer
    reachable). Lets a rejoiner catch up from a ring peer that itself
    rejoined on a new port earlier. ``skip`` names the CALLING shard:
    a same-port rejoiner must never dial its own listed endpoint — the
    op would park on its own still-closed rejoin gate (deadlock)."""
    from .router import SHARD_ADDR_FMT, unpack_shard_addr

    best = 0
    for j, (h, p) in enumerate(peers):
        if j == idx or j == skip:
            continue
        try:
            cl = ControlPlaneClient(h, p, 0, secret=secret, streams=1)
            try:
                best = max(best,
                           int(cl.get(SHARD_ADDR_FMT.format(idx=idx))))
            finally:
                cl.close()
        except (OSError, RuntimeError):
            continue
    dec = unpack_shard_addr(best)
    return (dec[1], dec[2]) if dec else None


def _rejoin_catch_up(srv, idx: int, peers, secret: str,
                     nt: int = 1) -> None:
    """Restarted-shard catch-up, two pulls with distinct roles:

    1. From the ring SUCCESSOR — this shard's own keyspace, which the
       successor replicated and has been serving since the death. The
       load also RESUMES this shard's WAL numbering (``adopt_wal``) from
       the fence the successor holds against this shard's stream: a
       restart back at zero would leave every post-rejoin record at or
       below that stale fence — silently dropped-and-acked by the
       successor, i.e. lost on this shard's next death.
    2. From the ring PREDECESSOR — ITS keyspace (this shard's replica
       role). The pull carries the receiver flag (``rearm``): serving it
       re-arms the predecessor's degraded stream from that exact cut,
       and ``set_fence`` adopts the cut's fence so the resumed stream
       skips records already folded in — gap-free.

    For a two-shard ring both roles are the same endpoint, so one
    unfiltered receiver-flagged pull carries everything at a single cut
    (two filtered pulls would open a gap between their cuts).

    Quorum mode (``nt`` >= 2 successor streams) generalizes both roles:
    the own-keyspace pull works from ANY surviving replica — every live
    successor is probed and the copy whose resume fence is NEWEST wins
    (taking the max is the gap check: resuming below a survivor's fence
    would leave post-rejoin records silently dropped-and-acked there) —
    and the replica role covers each of the nt ring PREDECESSORS with
    its own receiver-flagged pull (per-source fences, per-source
    re-arm). Dead predecessors are skipped: their streams restart fresh
    when they themselves rejoin, and this shard's per-source fence
    dedups the overlap."""
    n = len(peers)
    succ = (idx + 1) % n
    pred = (idx - 1) % n
    deadline = time.monotonic() + float(knob_env("BFT_CP_REJOIN_TIMEOUT"))
    last = None
    # quorum-mode pulls identify this shard to the serving peer via the
    # frame rank -(100+idx): the peer picks the resume fence of THIS
    # shard's stream and re-arms exactly this receiver's target stream
    snap_rank = -(100 + idx) if nt >= 2 else 0

    def _dial_peer(j):
        h, p = _published_addr(peers, j, secret, skip=idx) or peers[j]
        return ControlPlaneClient(h, p, snap_rank, secret=secret, streams=1)

    while True:
        try:
            if nt >= 2:
                import struct as _struct

                best_blob, best_resume, best_src = None, -1, -1
                for k in range(1, nt + 1):
                    s = (idx + k) % n
                    try:
                        cl = _dial_peer(s)
                    except (OSError, RuntimeError):
                        continue
                    try:
                        blob = cl.snapshot(n, idx)
                    finally:
                        cl.close()
                    if len(blob) < 16:
                        continue
                    resume = _struct.unpack("<Q", blob[8:16])[0]
                    if resume > best_resume or best_blob is None:
                        best_blob, best_resume, best_src = blob, resume, s
                if best_blob is None:
                    raise OSError(
                        f"no surviving replica of shard {idx}'s keyspace "
                        f"answered (probed {nt} ring successors)")
                srv.load_snapshot(best_blob, set_fence=False,
                                  adopt_wal=True, src_idx=idx)
                rearmed = []
                for k in range(1, nt + 1):
                    p_idx = (idx - k) % n
                    if p_idx == idx:
                        continue
                    try:
                        pcl = _dial_peer(p_idx)
                    except (OSError, RuntimeError):
                        continue  # dead predecessor: see docstring
                    try:
                        srv.load_snapshot(
                            pcl.snapshot(n, p_idx, rearm=True),
                            set_fence=True, src_idx=p_idx)
                        rearmed.append(p_idx)
                    finally:
                        pcl.close()
                logger.warning(
                    "shard %d: quorum rejoin catch-up complete (own "
                    "keyspace from shard %d at fence %d; re-armed "
                    "predecessor streams %s)", idx, best_src, best_resume,
                    rearmed or "none")
                return
            # a ring peer may itself have moved in an earlier rejoin; its
            # published address supersedes the static peer list
            host, port = _published_addr(peers, succ, secret, skip=idx) \
                or peers[succ]
            cl = ControlPlaneClient(host, port, 0, secret=secret, streams=1)
            try:
                if n <= 2:
                    # successor == predecessor: one cut carries both the
                    # served keyspace and the replica keyspace; the fence,
                    # the WAL resume, and the stream re-arm all anchor to
                    # that single cut
                    srv.load_snapshot(cl.snapshot(rearm=True),
                                      set_fence=True, adopt_wal=True)
                else:
                    srv.load_snapshot(cl.snapshot(n, idx), set_fence=False,
                                      adopt_wal=True)
                    ph, pp = _published_addr(peers, pred, secret,
                                             skip=idx) or peers[pred]
                    pcl = ControlPlaneClient(ph, pp, 0, secret=secret,
                                             streams=1)
                    try:
                        srv.load_snapshot(pcl.snapshot(n, pred, rearm=True),
                                          set_fence=True)
                    finally:
                        pcl.close()
            finally:
                cl.close()
            logger.warning("shard %d: rejoin catch-up complete (snapshot "
                           "from shard %d)", idx, succ)
            return
        except (OSError, RuntimeError) as exc:
            last = exc
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"shard {idx}: rejoin catch-up failed within "
                    f"BFT_CP_REJOIN_TIMEOUT: {last}") from last
            time.sleep(0.2)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    export_native_knobs()
    max_mb = args.mailbox_max_mb
    if max_mb is None:
        max_mb = float(knob_env("BFT_CP_MAILBOX_MAX_MB"))
    cap = int(max_mb * (1 << 20))
    secret = knob_env("BFT_CP_SECRET") or ""
    # --rejoin arms the rejoin gate ATOMICALLY with the bind: any op
    # served against the not-yet-loaded store would lose records now and
    # resurrect them out of order later. The cap self-publish is skipped
    # in that case — a loopback put would park on the gate, and the
    # snapshot restores the key anyway.
    srv = ControlPlaneServer(args.world, args.port, secret=secret,
                             max_mailbox_bytes=cap,
                             rejoin_pending=args.rejoin)
    if not args.rejoin:
        # Self-publish the effective cap (value + 1 so 0 still means "not
        # published") through a loopback client; origins size deposit
        # pre-checks against the SERVING side's cap, and the attach-time
        # agreement check compares every shard's copy.
        try:
            cl = ControlPlaneClient("127.0.0.1", srv.port, 0, secret=secret,
                                    streams=1)
            cl.put("bf.cp.mailbox_cap_bytes", cap + 1)
            cl.close()
        except OSError as exc:  # serve anyway; attach falls back to knob
            logger.warning("shard %d: mailbox-cap self-publish failed (%s)",
                           args.shard, exc)

    peers = _parse_peers(args.peers) if args.peers else None
    if args.expect_peers:
        # two-phase: report the bound port, then wait for the full ring
        print(f"BF_SHARD_PORT {srv.port}", flush=True)
        line = sys.stdin.readline()
        if not line.startswith("BF_SHARD_PEERS"):
            print(f"shard_server: expected a BF_SHARD_PEERS line, got "
                  f"{line!r}", file=sys.stderr)
            srv.stop()
            return 2
        peers = _parse_peers(line.split(None, 1)[1])
    nt = _successor_count(len(peers)) if peers else 0
    if args.rejoin and not (peers and len(peers) > 1 and nt):
        print("shard_server: --rejoin requires a peer ring with "
              "BFT_CP_REPLICATION enabled (the gate would never "
              "open)", file=sys.stderr)
        srv.stop()
        return 2
    if peers and len(peers) > 1:
        _arm_partition_from_env(peers, args.shard)
    addr_val = None
    if peers and nt:
        if args.rejoin:
            _rejoin_catch_up(srv, args.shard, peers, secret, nt)
        if nt >= 2:
            targets = []
            for k in range(1, nt + 1):
                s = (args.shard + k) % len(peers)
                th, tp = (_published_addr(peers, s, secret, skip=args.shard)
                          if args.rejoin else None) or peers[s]
                targets.append((s, th, tp))
            srv.set_successors(targets, len(peers), args.shard)
            sh, sp = targets[0][1], targets[0][2]
            logger.info("shard %d: quorum WAL replication to %d ring "
                        "successors %s (commit = %d acks)", args.shard, nt,
                        [f"{t[1]}:{t[2]}" for t in targets], (nt + 2) // 2)
        else:
            succ_idx = (args.shard + 1) % len(peers)
            sh, sp = (_published_addr(peers, succ_idx, secret,
                                      skip=args.shard)
                      if args.rejoin else None) or peers[succ_idx]
            srv.set_successor(sh, sp, len(peers), args.shard)
            logger.info("shard %d: WAL replication to ring successor %s:%d",
                        args.shard, sh, sp)
        if args.rejoin:
            # Announce alive ONLY NOW — after our own WAL stream is armed.
            # Routers flip traffic back the moment they see the even
            # generation, and an op served before set_successor would be
            # acked UNREPLICATED (a split-brain seed). Monotone put_max + the successor's
            # WAL propagate the flag to every shard. The next even
            # generation also stamps bf.cp.shard_addr.<i> with THIS
            # server's endpoint — the key routers consult before the
            # rejoin re-dial, which is what lets a restart land on a new
            # host:port (--port 0 included).
            from .router import pack_shard_addr

            adv_host = args.advertise_host or \
                (peers[args.shard][0] if args.shard < len(peers)
                 else "127.0.0.1")
            try:
                cl = ControlPlaneClient(sh, sp, 0, secret=secret,
                                        streams=1)
                flag = f"bf.cp.shard_dead.{args.shard}"
                cur = cl.put_max(flag, 0)
                # odd (dead) -> next even; even -> next even AGAIN so the
                # generation stamped into the address key is strictly
                # fresher than any earlier rejoin's (put_max can then
                # never keep a stale endpoint)
                new_gen = cur + 1 if cur % 2 == 1 else cur + 2
                cl.put_max(flag, new_gen)
                addr_val = pack_shard_addr(new_gen, adv_host, srv.port)
                cl.put_max(f"bf.cp.shard_addr.{args.shard}", addr_val)
                cl.close()
            except OSError as exc:
                logger.warning("shard %d: alive-generation publish failed "
                               "(%s); routers will not re-route until an "
                               "operator republishes it", args.shard, exc)

    # a graceful stop may come as soon as the marker is out: handle it
    # from before the marker on
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    print(f"{READY_MARKER} {srv.port}", flush=True)
    logger.info("control-plane shard %d serving on port %d (world %d, "
                "mailbox cap %d bytes)", args.shard, srv.port, args.world,
                cap)

    if peers and nt:
        # Alive keeper: a router whose redirect-verify dial loses a race
        # under a connect storm can FALSELY publish an odd (dead)
        # liveness generation for this perfectly live shard — and nothing
        # else would ever re-even it (the rejoin publish is one-shot).
        # While this process lives, it periodically re-asserts the next
        # even generation through its ring successor (whose WAL chains
        # the monotone put_max around the ring), so a false death claim
        # self-corrects within a poll interval; a real death stops the
        # keeper with the process.
        #
        # Quorum mode adds two partition rules. (1) While this server is
        # below its commit quorum (minority side of a cut) it must NOT
        # re-even its own flag: the majority legitimately declared it
        # dead and failed its keyspace over — re-asserting alive from
        # the minority would split-brain the routing. (2) Once quorum is
        # restored, a flag still odd means routers served this shard's
        # keyspace elsewhere during the episode, so its local copy is
        # stale: a guarded IN-PLACE self-rejoin (reset_store + snapshot
        # catch-up from the surviving replicas, then reopening the gate)
        # rebuilds it exactly like a restarted process before the next
        # even generation announces it back.
        flag = f"bf.cp.shard_dead.{args.shard}"
        addr_key = f"bf.cp.shard_addr.{args.shard}"

        def _alive_keeper() -> None:
            from .router import pack_shard_addr

            cl = None
            saw_qlost = False
            adv_host = args.advertise_host or peers[args.shard][0]
            while not done.wait(2.0):
                try:
                    if nt >= 2 and \
                            (srv.stats() or {}).get("quorum_state") == 2:
                        saw_qlost = True
                        continue  # rule (1): never re-assert below quorum
                    if cl is None:
                        ah, ap = _published_addr(
                            peers, (args.shard + 1) % len(peers), secret,
                            skip=args.shard) \
                            or peers[(args.shard + 1) % len(peers)]
                        cl = ControlPlaneClient(ah, ap, 0, secret=secret,
                                                streams=1)
                    cur = cl.put_max(flag, 0)
                    if cur < 0:
                        # transport-level failure surfaces as -1, not an
                        # exception: the successor died (possibly to come
                        # back on a NEW port) — drop the client and
                        # re-resolve its published address next tick
                        cl.close()
                        cl = None
                        continue
                    if cur % 2 == 1:
                        if nt >= 2 and saw_qlost:
                            # rule (2): flagged dead during a real quorum
                            # loss — the keyspace moved; rebuild in place
                            # before announcing alive
                            try:
                                srv.reset_store()
                                _rejoin_catch_up(srv, args.shard, peers,
                                                 secret, nt)
                                srv.rejoin_done()
                            except (OSError, RuntimeError) as exc:
                                logger.error(
                                    "shard %d: post-partition self-rejoin "
                                    "failed (%s); staying flagged dead, "
                                    "retrying next tick", args.shard, exc)
                                continue
                            saw_qlost = False
                            logger.warning(
                                "shard %d: post-partition self-rejoin "
                                "complete (store rebuilt from surviving "
                                "replicas)", args.shard)
                        cl.put_max(flag, cur + 1)
                        if addr_val is not None or (nt >= 2 and cur > 0):
                            # a moved shard's endpoint must outlive false
                            # death claims: restamp it at the new even gen
                            cl.put_max(addr_key,
                                       pack_shard_addr(
                                           cur + 1, adv_host, srv.port))
                        logger.warning(
                            "shard %d: re-asserted ALIVE (liveness "
                            "generation %d -> %d; a peer's death claim "
                            "was spurious)", args.shard, cur, cur + 1)
                    else:
                        # quorum (if it was lost) is held again and no
                        # router flagged us dead: streams were only
                        # suspect-parked across the cut and resume
                        # gap-free — no rebuild needed
                        saw_qlost = False
                        if addr_val is not None:
                            cl.put_max(addr_key, addr_val)
                except OSError:
                    if cl is not None:
                        cl.close()
                    cl = None  # successor briefly away; redial next tick
            if cl is not None:
                cl.close()

        # Never joined: the keeper must die WITH the process (a real death
        # must stop the re-assertions); the `done` event stops it on a
        # graceful SIGTERM.
        threading.Thread(target=_alive_keeper, daemon=True,
                         name="bf-shard-alive").start()
    done.wait()
    srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
