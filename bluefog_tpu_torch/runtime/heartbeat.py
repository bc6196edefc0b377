"""Controller heartbeats: failure detection and coordinated shutdown.

Counterpart of ``bluefog_tpu/runtime/heartbeat.py``. The reference's
background loop gives every rank two liveness guarantees: a stalled peer is
*detected* (CheckForStalledTensors, operations.cc:387-432) and shutdown is
*coordinated*: a worker's shutdown request reaches every other, so no rank
blocks on a departed peer (operations.cc:830-909, 1074-1095). Here both
ride the control-plane KV:

  * every controller bumps ``bf.hb.<pid>`` on a cadence
    (``BFT_HEARTBEAT_INTERVAL``, 5 s);
  * a monitor thread watches the other controllers' counters and reports a
    peer whose heartbeat stops advancing for longer than
    ``BFT_HEARTBEAT_TIMEOUT`` seconds (30) as dead;
  * ``bf.shutdown()`` publishes ``bf.shutdown.flag.<pid>``; peers' monitors
    surface it through :func:`shutdown_requested`, so a training loop can
    leave before it waits in a collective on a departed peer.

A controller is a process, and in the port a process holds one rank, so a
controller's index is its control-plane rank (``control_plane.
process_index()``) and :func:`dead_ranks` projects the dead controllers
through ``control_plane.owned_ranks``. ``bf.init`` starts the monitor when
a control plane of more than one controller is attached
(``control_plane.world() > 1``); a job of one has no peer to watch.

The KV keys and values are the JAX package's, so a JAX monitor and a port
monitor on one server see each other: ``bf.hb.<pid>``,
``bf.shutdown.flag.<pid>``/``bf.shutdown.ack.<pid>``,
``bf.membership.epoch``, the server's incarnation mirror ``bf.inc.<pid>``
and the quarantine phase ``bf.q.<pid>.<inc>`` (1 entered, 2 complete).

Coordination protocol: every process announces ITS OWN shutdown under
``bf.shutdown.flag.<pid>``; a monitor that sees a peer's flag latches
``shutdown_requested`` and acknowledges under ``bf.shutdown.ack.<pid>``.
The first announcer waits (bounded by ``BFT_SHUTDOWN_GRACE``) until every
peer has acked or announced its own shutdown before it tears its
control-plane server down: otherwise process 0 would stop the server
before the interval-cadence monitors ever read the flag.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from . import control_plane as _cp
from . import flight as _flight
from . import metrics as _metrics
from . import timeseries as _timeseries
from . import tuner as _tuner
from .config import knob_env
from .logging import logger
from .timeline import timeline_instant

_FLAG = "bf.shutdown.flag."
_ACK = "bf.shutdown.ack."
_EPOCH_KEY = "bf.membership.epoch"
# Per-rank incarnation mirror (written by the server when a client
# attaches) and per-(rank, incarnation) quarantine phase: 1 = attached and
# quarantined (state transfer pending), 2 = transfer complete (eligible
# for re-admission).
_INC = "bf.inc."
_QUARANTINE = "bf.q."
_Q_ENTERED = 1
_Q_COMPLETE = 2


class PeerMonitor:
    """Heartbeat publisher and peer liveness / shutdown-flag watcher.

    A peer whose heartbeat RESUMES after it was declared dead is not
    re-admitted on that alone: it moves to a ``suspect`` set (logged at
    ERROR) while staying in the dead set, and returns to live membership
    only once the control plane shows a NEW incarnation registered for it
    AND that incarnation's quarantine (state transfer) completed. A
    flapping peer (same incarnation, stale parameters, stale server-side
    identity) therefore never rejoins the averaging graph.
    """

    def __init__(self, process_index: int, process_count: int,
                 interval_sec: Optional[float] = None,
                 timeout_sec: Optional[float] = None) -> None:
        self.me = process_index
        self.world = process_count
        self.interval = interval_sec if interval_sec is not None else float(
            knob_env("BFT_HEARTBEAT_INTERVAL"))
        self.timeout = timeout_sec if timeout_sec is not None else float(
            knob_env("BFT_HEARTBEAT_TIMEOUT"))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._shutdown_seen = threading.Event()
        self._last_value: Dict[int, int] = {}
        self._last_change: Dict[int, float] = {}
        self._dead: set = set()
        self._suspect: set = set()       # resumed-but-unfenced peers
        self._dead_inc: Dict[int, int] = {}  # incarnation at death time
        self._epoch: int = 0             # membership-epoch mirror
        self._cl = None  # dedicated control-plane connection (see start())
        self._partition_rejects_seen = 0  # cp.partitions counter baseline
        self._quorum_lost_last = 0       # edge-detect for timeline instants

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None or not _cp.active():
            return
        # A connection of its own: the shared client's mutex is held for
        # the full round trip of every call, and blocking ops park it in
        # server-side waits (locks, barriers). A heartbeat riding that
        # connection would go silent exactly when the job is busiest, and
        # silence past BFT_HEARTBEAT_TIMEOUT makes live peers declare this
        # controller dead.
        try:
            self._cl = _cp.extra_client()
        except (OSError, RuntimeError) as exc:
            logger.warning(
                "heartbeat: dedicated control-plane connection failed (%s); "
                "falling back to the shared one", exc)
            self._cl = None
        self._thread = threading.Thread(
            target=self._loop, name="bft-heartbeat", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)
            if thread.is_alive():
                # The tick is wedged in a control-plane call (a hung
                # server: the very case this monitor exists to detect).
                # Closing the native client now would free it under the
                # thread; leave it to be reclaimed at process exit.
                logger.warning(
                    "heartbeat thread did not exit within 2 s (control plane "
                    "unresponsive?); leaving its connection open")
                self._cl = None
                return
        if self._cl is not None:
            self._cl.close()
            self._cl = None

    # -- queries -----------------------------------------------------------

    @property
    def shutdown_seen(self) -> bool:
        return self._shutdown_seen.is_set()

    def dead_peers(self) -> set:
        return set(self._dead)

    def suspect_peers(self) -> set:
        """Peers whose heartbeat resumed but whose re-admission gate has
        not cleared (still counted dead for membership purposes)."""
        return set(self._suspect)

    @property
    def membership_epoch(self) -> int:
        """Locally mirrored shared membership epoch (refreshed per tick and
        bumped at once on local transitions): readable every step without
        a server round trip."""
        return self._epoch

    # -- the loop ----------------------------------------------------------

    def _bump_epoch(self, cl) -> None:
        try:
            self._epoch = int(cl.fetch_add(_EPOCH_KEY, 1)) + 1
        except OSError:
            self._epoch += 1  # local monotonicity is what consumers need

    def _poll_shards(self, cl) -> None:
        """Per-shard control-plane liveness (sharded deployments only):
        adopt peer-published failover flags, check that each live shard
        still answers, and put transitions into the metrics and the
        timeline. This cadence is what makes every process converge on
        the same shrunken shard ring within one interval of a shard's
        death."""
        before = cl.dead_shards()
        dead = cl.poll_shard_health()
        _metrics.gauge("cp.shards").set(cl.shard_count)
        _metrics.gauge("cp.dead_shards").set(len(dead))
        for idx in sorted(dead - before):
            timeline_instant(f"cp.shard.{idx}", "SHARD_DEAD")
        for idx in sorted(before - dead):
            timeline_instant(f"cp.shard.{idx}", "SHARD_REJOIN")
        # Replication health: the largest WAL lag across live shards, the
        # shards serving unreplicated, and those below their commit quorum.
        try:
            lag = 0
            under = 0
            qlost = 0
            rejects = 0
            for _name, st in cl.server_stats_all():
                if not st:
                    continue
                if st.get("repl_status") == 1:
                    lag = max(lag, st["wal_enqueued"] - st["wal_acked"])
                elif st.get("repl_status") == 2:
                    under += 1
                # a shard below its commit quorum serves reads but rejects
                # mutating ops: the partition gauge operators watch
                if st.get("quorum_state") == 2:
                    qlost += 1
                rejects += int(st.get("partition_rejects", 0))
            _metrics.gauge("cp.repl_lag").set(lag)
            _metrics.gauge("cp.under_replicated").set(under)
            _metrics.gauge("cp.quorum_lost").set(qlost)
            prev = self._partition_rejects_seen
            if rejects > prev:
                # one flight instant per NEW episode (the first rejected
                # op after a clean interval): dumps pin when the cut began
                _metrics.counter("cp.partitions").inc(rejects - prev)
                if prev == 0:
                    try:
                        _flight.recorder().instant("cp.partition",
                                                   a=float(rejects))
                    except Exception:  # noqa: BLE001 — telemetry only
                        pass
                self._partition_rejects_seen = rejects
            if qlost != self._quorum_lost_last:
                for_ = "LOST" if qlost else "RESTORED"
                timeline_instant("cp.quorum", f"QUORUM_{for_}")
                self._quorum_lost_last = qlost
        except (OSError, RuntimeError):
            pass  # the stats probe must never break the heartbeat cadence

    def _tick(self) -> None:
        cl = self._cl if self._cl is not None else _cp.client()
        if hasattr(cl, "poll_shard_health"):
            self._poll_shards(cl)
        cl.put(f"bf.hb.{self.me}", int(time.monotonic_ns() & 0x7FFFFFFFFFFF))
        now = time.monotonic()
        for peer in range(self.world):
            if peer == self.me:
                continue
            v = cl.get(f"bf.hb.{peer}")
            if v != self._last_value.get(peer):
                self._last_value[peer] = v
                self._last_change[peer] = now
                if peer in self._dead and peer not in self._suspect:
                    # A raw heartbeat resume alone must NEVER shrink the
                    # dead set: the peer's parameters and server-side
                    # identity (dedup tables, mailbox deposits, lock
                    # holdings) are stale. It becomes a tracked suspect
                    # until the re-admission gate below clears it.
                    self._suspect.add(peer)
                    self._bump_epoch(cl)
                    _metrics.counter("hb.suspect_transitions").inc()
                    timeline_instant(f"controller.{peer}", "SUSPECT")
                    logger.error(
                        "controller %d heartbeat RESUMED without a new "
                        "incarnation registration: keeping it out of live "
                        "membership (suspect) until it re-attaches with a "
                        "bumped incarnation and completes quarantined state "
                        "transfer; a flapping peer must not rejoin with "
                        "stale state", peer)
            elif (now - self._last_change.get(peer, now) > self.timeout
                  and peer not in self._dead):
                self._dead.add(peer)
                self._suspect.discard(peer)
                try:
                    self._dead_inc[peer] = int(cl.get(f"{_INC}{peer}"))
                except OSError:
                    self._dead_inc[peer] = 0
                self._bump_epoch(cl)
                _metrics.counter("hb.dead_transitions").inc()
                timeline_instant(f"controller.{peer}", "DEAD")
                logger.error(
                    "controller %d heartbeat missing for %.0f s: peer "
                    "failure detected; collectives involving its ranks "
                    "will hang (reference analog: missing-rank stall, "
                    "operations.cc:387-432)", peer, self.timeout)
        # Re-admission gate: a suspect returns to live membership only once
        # the server shows a NEW incarnation registered for it (it went
        # through the fenced rejoin, so its zombie predecessor is cut off)
        # AND that incarnation finished quarantine (its state transfer
        # completed, so the values it gossips are current).
        for peer in sorted(self._suspect):
            try:
                inc = int(cl.get(f"{_INC}{peer}"))
                phase = int(cl.get(f"{_QUARANTINE}{peer}.{inc}")) \
                    if inc > self._dead_inc.get(peer, 0) else 0
            except OSError:
                continue
            if phase >= _Q_COMPLETE:
                self._suspect.discard(peer)
                self._dead.discard(peer)
                self._dead_inc[peer] = inc
                self._bump_epoch(cl)
                _metrics.counter("hb.readmissions").inc()
                timeline_instant(f"controller.{peer}", "READMIT")
                logger.warning(
                    "controller %d re-admitted to live membership: "
                    "incarnation %d registered and quarantine complete",
                    peer, inc)
        try:
            shared = int(cl.get(_EPOCH_KEY))
            if shared > self._epoch:
                self._epoch = shared
        except OSError:
            pass
        # The telemetry planes ride this tick: membership mirrored into the
        # registry, the interval-gated metrics publication, the time-series
        # sample and its publication, the tuner's tick (a no-op unless
        # BFT_TUNE=1; riding the heartbeat gives it a cadence even when the
        # training step stalls), and the remote dump trigger's poll: no
        # extra thread and no per-step round trip.
        _metrics.gauge("membership.epoch").set(self._epoch)
        _metrics.gauge("hb.dead_peers").set(len(self._dead))
        _metrics.gauge("hb.suspect_peers").set(len(self._suspect))
        _metrics.maybe_publish(cl)
        _timeseries.maybe_sample(cl)
        _tuner.maybe_tick(cl)
        _flight.poll_remote_trigger(cl)
        if not self._shutdown_seen.is_set() and any(
                cl.get(f"{_FLAG}{p}") for p in range(self.world)
                if p != self.me):
            self._shutdown_seen.set()
            cl.put(f"{_ACK}{self.me}", 1)  # let the announcer stop waiting
            logger.info(
                "coordinated shutdown requested by a peer controller "
                "(reference analog: SHUTDOWN broadcast, operations.cc"
                ":1074-1095)")

    def _loop(self) -> None:
        failures = 0
        while not self._stop.wait(self.interval):
            try:
                self._tick()
                if failures >= 3:
                    logger.warning(
                        "heartbeat recovered after %d failed ticks", failures)
                failures = 0
            except Exception as exc:  # noqa: BLE001 — observability thread
                # Retry forever: the monitor must outlive transient KV and
                # socket outages (it tolerates `timeout` seconds of peer
                # silence, so it must tolerate as much of its own).
                # shutdown stops this thread BEFORE it detaches the control
                # plane, so teardown never strands it spinning.
                failures += 1
                if failures == 3:
                    logger.warning(
                        "heartbeat ticks failing (%s); retrying every "
                        "%.1f s; peer failure detection degraded until the "
                        "control plane recovers", exc, self.interval)
                else:
                    logger.debug("heartbeat tick failed (retrying): %s", exc)


def announce_shutdown(process_index: int, process_count: int,
                      grace_sec: Optional[float] = None) -> None:
    """Publish this process's shutdown flag and wait for peers to see it.

    The wait makes the coordination real: the announcer may host the
    control-plane server, and stopping it before the interval-cadence peer
    monitors have read the flag would defeat the broadcast. A peer counts
    as notified once it acks or announces its own shutdown; the wait is
    bounded by ``BFT_SHUTDOWN_GRACE`` seconds (default: 3x the heartbeat
    interval) so crashed peers cannot hang teardown.
    """
    if not _cp.active():
        return
    try:
        cl = _cp.client()
        peer_already_announced = any(
            cl.get(f"{_FLAG}{p}") for p in range(process_count)
            if p != process_index)
        cl.put(f"{_FLAG}{process_index}", 1)
        cl.put(f"{_ACK}{process_index}", 1)
        if peer_already_announced:
            return  # coordination already under way; no need to wait
        grace = grace_sec if grace_sec is not None else \
            knob_env("BFT_SHUTDOWN_GRACE")
        if grace is None:
            grace = 3 * float(knob_env("BFT_HEARTBEAT_INTERVAL"))
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            if all(cl.get(f"{_ACK}{p}") or cl.get(f"{_FLAG}{p}")
                   for p in range(process_count)):
                return
            time.sleep(0.05)
        logger.warning(
            "shutdown grace (%.1f s) expired with unacknowledged peers; "
            "proceeding with teardown", grace)
    except Exception as exc:  # noqa: BLE001 — best effort during teardown
        logger.debug("shutdown announce failed: %s", exc)


def _monitor() -> Optional[PeerMonitor]:
    from .state import _global_state

    return _global_state().peer_monitor


def shutdown_requested() -> bool:
    """True once any controller in the job has called ``bf.shutdown()``.

    A training loop of several processes can poll this to leave before it
    issues a collective that would hang on the departed peer.
    """
    mon = _monitor()
    return bool(mon is not None and mon.shutdown_seen)


def dead_controllers() -> set:
    """Controller process indexes whose heartbeats have gone silent.

    A peer lands here after ``BFT_HEARTBEAT_TIMEOUT`` seconds without a
    counter advance: a *crash* signal (no coordinated announce), the
    cross-process analog of the reference's missing-rank stall report
    (operations.cc:387-432). Empty in a job of one controller.
    """
    mon = _monitor()
    return mon.dead_peers() if mon is not None else set()


def suspect_controllers() -> set:
    """Controllers whose heartbeat resumed but which are still fenced out
    of live membership (see :class:`PeerMonitor`). A subset of
    :func:`dead_controllers`: membership-wise they are still dead."""
    mon = _monitor()
    return mon.suspect_peers() if mon is not None else set()


def membership_epoch() -> int:
    """Monotonic membership-epoch counter (0 with no control plane).

    Bumped by the control-plane server on every incarnation registration
    (join, rejoin) and by heartbeat monitors on dead-set transitions
    (death, suspect, re-admission): the cheap "did membership change?"
    probe. With a live monitor the read is its local mirror (no server
    round trip)."""
    mon = _monitor()
    if mon is not None:
        return mon.membership_epoch
    return _cp.membership_epoch_kv()


# -- quarantine (the rejoining process's side) --------------------------------
#
# A restarted rank (BFT_INCARNATION > 0) is *quarantined* between its fenced
# attach and the completion of state transfer: it is visible in membership
# (its incarnation is registered, so its zombie is cut off) but survivors
# keep its ranks out of averaging until `complete_quarantine` publishes
# phase 2, the re-admission gate PeerMonitor._tick checks.

_q_state = {"pending": False, "pid": 0, "inc": 0, "t0": 0.0}


def quarantine_pending() -> bool:
    """True between this process's quarantined attach and the completion of
    its state transfer (always False for incarnation-0 launches)."""
    return _q_state["pending"]


def enter_quarantine(process_index: int) -> None:
    """Mark this process quarantined (``bf.init`` calls it when attaching
    with a bumped incarnation). Publishes phase 1 under the per-(rank,
    incarnation) key so survivors can observe the rejoin in progress."""
    inc = _cp.incarnation()
    if not _cp.active() or inc <= 0:
        _q_state["pending"] = False
        return
    _q_state.update(pending=True, pid=process_index, inc=inc,
                    t0=time.monotonic())
    _metrics.counter("hb.quarantine_entries").inc()
    timeline_instant(f"controller.{process_index}", "QUARANTINE_ENTER")
    try:
        _cp.client().put(f"{_QUARANTINE}{process_index}.{inc}", _Q_ENTERED)
    except OSError as exc:
        logger.warning("quarantine entry publish failed (%s)", exc)
    logger.warning(
        "rejoining as incarnation %d: QUARANTINED until state transfer "
        "completes; this rank is registered (zombie fenced) but excluded "
        "from averaging", inc)


def complete_quarantine() -> None:
    """Publish quarantine completion (phase 2) and bump the membership
    epoch so survivors' monitors re-admit this rank. Idempotent."""
    if not _q_state["pending"]:
        return
    _q_state["pending"] = False
    # how long this rank sat fenced while transferring: the rejoin latency
    _metrics.histogram("hb.quarantine_sec").observe(
        time.monotonic() - _q_state["t0"])
    timeline_instant(f"controller.{_q_state['pid']}", "QUARANTINE_COMPLETE")
    try:
        cl = _cp.client()
        cl.put(f"{_QUARANTINE}{_q_state['pid']}.{_q_state['inc']}",
               _Q_COMPLETE)
        _cp.bump_membership_epoch()
    except (OSError, RuntimeError) as exc:
        logger.warning("quarantine completion publish failed (%s)", exc)
        return
    logger.warning(
        "quarantine complete: state transfer finished; survivors re-admit "
        "this rank at their next heartbeat tick")


def dead_ranks() -> set:
    """Ranks whose controller's heartbeat has gone silent: the rank-level
    projection of :func:`dead_controllers` through
    ``control_plane.owned_ranks`` (one rank per controller in the port).
    Empty in a job of one controller."""
    return {r for pidx in dead_controllers()
            for r in _cp.owned_ranks(pidx)}
