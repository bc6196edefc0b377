"""Rank-local online performance controller: the self-tuning wire.

Counterpart of ``bluefog_tpu/runtime/tuner.py``. The knobs that carry the
cheap-neighbor-gossip bet (the window plane, the window codec, the
topology's in-degree) are static, while the time-series plane
(``runtime/timeseries.py``) measures what they trade off. This controller,
ticked from the heartbeat and sampler cadence, reads the streaming series
and moves three levers:

* **per-edge plane**: measured per-edge wire bytes feed each hosted
  window's ``PlanePlanner.ingest_live`` as online overrides of its static
  size-floor estimate; a re-plan happens only when a verdict flips.
* **per-edge codec**: sustained-slow out-edges escalate
  ``none -> int8 -> topk`` through ``Window.set_edge_codec``; EF-residual
  pressure or a ``consensus_stall`` alert de-escalates.
* **per-rank in-degree**: a sustained straggler (the health view's
  step-counter spread) is demoted to fewer in-edges with total-preserving
  column renormalization (``topology.demote_in_edges``), published under
  ``bf.tune.demoted`` for the optimizers' healed tables, and promoted back
  on recovery; the round trip restores the weight matrix exactly.

The levers act on the process's windows (``_global_state().windows``);
with none, which is every port job until the window layer lands, a
decision moves nothing (``_actuate`` reports it skipped).

Safety properties:

* **Off by default**: ``BFT_TUNE=0`` takes no KV reads, changes nothing,
  and leaves every wire byte as in the untuned build.
* **Epoch-fenced**: each decision's snapshot captures the membership epoch
  (``runtime/heartbeat.py``) and re-checks it just before actuating; a
  rejoin or death racing the decision defers it to the next tick.
  In-degree moves publish ``bf.tune.demoted`` and then BUMP the membership
  epoch, so every optimizer applies them at the same re-plan boundary
  rejoins use.
* **Hysteresis-gated**: a lever moves only after its trigger held for
  ``slow_for``/``straggler_for`` seconds and never twice within ``dwell``
  seconds of the same target: the controller cannot flap.
* **Observable**: every decision lands as a flight instant
  (``tune.<lever>``), a ``tune.decisions`` series sample, and the
  ``bf.tune.<rank>`` KV document (the decision trail).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .config import knob_env
from .logging import logger

Edge = Tuple[int, int]

# KV keys: the shared demotion document (one per job, epoch-fenced) and
# the per-rank decision trail.
DEMOTE_KEY = "bf.tune.demoted"
TUNE_KEY_FMT = "bf.tune.{rank}"

# Codec escalation ladder, cheapest wire last. Escalation only ever moves
# one rung per decision (hysteresis does the rest); de-escalation walks
# back the same rungs.
LADDER: Tuple[Optional[str], ...] = (None, "int8", "topk:0.01")

# Decision-table thresholds, overridable via BFT_TUNE_RULES
# (``key=value,...``). Kept as a flat dict so the grammar stays trivial
# and the table is printable.
DEFAULT_RULES: Dict[str, float] = {
    # an out-edge is SLOW when its measured bytes/s fall below
    # slow_ratio x the median across all measured edges...
    "slow_ratio": 0.5,
    # ...or below an absolute floor (bytes/s; 0 disables)...
    "min_bps": 0.0,
    # ...or its p99 deposit->drain transit exceeds this (ms; 0 disables)
    "transit_p99_ms": 0.0,
    # sustained-breach windows (seconds) before a lever may move
    "slow_for": 10.0,
    "straggler_for": 10.0,
    # min-dwell: seconds a target is immune after ANY actuation on it
    "dwell": 30.0,
    # de-escalate when the window EF residual norm exceeds this (0 =
    # only the consensus_stall alert de-escalates)
    "deesc_norm": 0.0,
    # in-edges a demoted straggler keeps (its fastest ones)
    "keep_in": 1.0,
}


def enabled() -> bool:
    return bool(knob_env("BFT_TUNE"))


def tune_interval() -> float:
    raw = knob_env("BFT_TUNE_INTERVAL")
    return 5.0 if raw is None else max(0.5, float(raw))


def parse_tune_rules(spec: Optional[str]) -> Dict[str, float]:
    """``key=value,...`` over :data:`DEFAULT_RULES`; unknown keys and
    malformed values warn and are skipped (tuning config must never take
    a job down — same contract as BFT_ALERT_RULES)."""
    rules = dict(DEFAULT_RULES)
    for term in (spec or "").split(","):
        term = term.strip()
        if not term:
            continue
        key, sep, val = term.partition("=")
        key = key.strip()
        if not sep or key not in rules:
            logger.warning("BFT_TUNE_RULES: skipping unknown term %r "
                           "(keys: %s)", term, ", ".join(sorted(rules)))
            continue
        try:
            rules[key] = float(val.strip())
        except ValueError:
            logger.warning("BFT_TUNE_RULES: skipping non-numeric term "
                           "%r", term)
    return rules


# ---------------------------------------------------------------------------
# Snapshot: everything one decision consumes, as plain data
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EdgeSample:
    """One edge's measured wire state at snapshot time."""

    bps: float = 0.0                    # measured bytes/s (0 = no data)
    p99_us: Optional[float] = None      # deposit->drain transit p99


@dataclasses.dataclass
class Snapshot:
    """Sensor state for one controller tick. ``decide`` consumes ONLY
    this (plus the controller's own hysteresis state), which is what
    makes the decision table unit-testable with synthetic series."""

    now: float
    epoch: int
    rank: int                           # this controller's process index
    owned: Set[int]                     # ranks this controller owns
    edges: Dict[Edge, EdgeSample] = dataclasses.field(default_factory=dict)
    stragglers: Set[int] = dataclasses.field(default_factory=set)
    alerts: Set[str] = dataclasses.field(default_factory=set)
    ef_norm: float = 0.0


@dataclasses.dataclass
class Decision:
    """One actuation the decision table emitted."""

    lever: str                          # "plane" | "codec" | "indegree"
    target: object                      # Edge, rank, or None (plane)
    action: str                         # escalate/deescalate/demote/...
    arg: object = None                  # codec spec, dropped-edge list...
    reason: str = ""


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------

class Tuner:
    """One rank-local controller instance (usually the module singleton).

    ``decide`` is a pure function of (Snapshot, hysteresis state) and is
    what the unit tests drive; ``tick`` wraps it with sensor gathering,
    the epoch fence, actuation, and the decision-trail publication."""

    def __init__(self, rank: int, world: int,
                 rules: Optional[Dict[str, float]] = None) -> None:
        self.rank = int(rank)
        self.world = int(world)
        self.rules = dict(rules) if rules is not None else \
            parse_tune_rules(knob_env("BFT_TUNE_RULES"))
        # hysteresis state: first-breach times per candidate move and
        # last-actuation times per target (min-dwell)
        self._breach: Dict[tuple, float] = {}
        self._last_act: Dict[tuple, float] = {}
        # current codec escalation level per out-edge (index into LADDER)
        self._level: Dict[Edge, int] = {}
        # in-edges dropped per demoted rank (this controller's view)
        self._demoted: Dict[int, FrozenSet[Edge]] = {}
        # measured-bps deltas: edge -> (t, cumulative bytes)
        self._edge_mark: Dict[Edge, Tuple[float, float]] = {}
        self._decisions: List[dict] = []    # trail ring (last 64)
        self._last_tick = 0.0

    # -- hysteresis helpers -------------------------------------------------

    def _dwell_ok(self, target: tuple, now: float) -> bool:
        last = self._last_act.get(target)
        return last is None or now - last >= self.rules["dwell"]

    def _sustained(self, key: tuple, breaching: bool, now: float,
                   for_sec: float) -> bool:
        """Sustained-breach gate: True once ``breaching`` has held for
        ``for_sec`` seconds (the alert rule engine's shape, per
        candidate)."""
        if not breaching:
            self._breach.pop(key, None)
            return False
        t0 = self._breach.setdefault(key, now)
        return now - t0 >= for_sec

    # -- the decision table -------------------------------------------------

    def decide(self, snap: Snapshot) -> List[Decision]:
        """Pure decision pass: consumes a snapshot, updates the breach
        clocks, returns the lever moves that cleared hysteresis. Does NOT
        actuate and does NOT start dwell windows — ``note_applied`` does,
        after the epoch-fenced actuation succeeds."""
        out: List[Decision] = []
        r = self.rules
        measured = sorted(s.bps for s in snap.edges.values() if s.bps > 0)
        med = measured[len(measured) // 2] if measured else 0.0

        # codec lever: escalate sustained-slow owned out-edges one rung
        for e in sorted(snap.edges):
            if e[0] not in snap.owned:
                continue
            s = snap.edges[e]
            slow = False
            why = ""
            if med > 0 and 0 < s.bps < r["slow_ratio"] * med:
                slow, why = True, (f"bps {s.bps:.0f} < {r['slow_ratio']:g}"
                                   f"x median {med:.0f}")
            if r["min_bps"] > 0 and 0 < s.bps < r["min_bps"]:
                slow, why = True, f"bps {s.bps:.0f} < floor {r['min_bps']:g}"
            if r["transit_p99_ms"] > 0 and s.p99_us is not None and \
                    s.p99_us > r["transit_p99_ms"] * 1000.0:
                slow, why = True, (f"transit p99 {s.p99_us / 1000:.0f} ms "
                                   f"> {r['transit_p99_ms']:g} ms")
            if self._sustained(("codec", e), slow, snap.now,
                               r["slow_for"]) and \
                    self._dwell_ok(("codec", e), snap.now):
                lvl = self._level.get(e, 0)
                if lvl < len(LADDER) - 1:
                    out.append(Decision("codec", e, "escalate",
                                        LADDER[lvl + 1], why))

        # codec de-escalation: compression is hurting convergence
        pressure = ""
        if "consensus_stall" in snap.alerts:
            pressure = "consensus_stall alert active"
        elif r["deesc_norm"] > 0 and snap.ef_norm > r["deesc_norm"]:
            pressure = (f"EF residual norm {snap.ef_norm:.3g} > "
                        f"{r['deesc_norm']:g}")
        if pressure:
            for e in sorted(self._level):
                lvl = self._level[e]
                if lvl > 0 and self._dwell_ok(("codec", e), snap.now):
                    out.append(Decision("codec", e, "deescalate",
                                        LADDER[lvl - 1], pressure))

        # in-degree lever: demote sustained stragglers, promote recovered
        for p in sorted(snap.stragglers):
            if p in self._demoted:
                self._breach.pop(("recover", p), None)
                continue
            if self._sustained(("straggler", p), True, snap.now,
                               r["straggler_for"]) and \
                    self._dwell_ok(("indegree", p), snap.now):
                out.append(Decision(
                    "indegree", p, "demote", None,
                    "step-counter spread straggler sustained "
                    f"{r['straggler_for']:g}s"))
        for p in sorted(set(self._demoted) - snap.stragglers):
            self._breach.pop(("straggler", p), None)
            if self._sustained(("recover", p), True, snap.now,
                               r["straggler_for"]) and \
                    self._dwell_ok(("indegree", p), snap.now):
                out.append(Decision("indegree", p, "promote", None,
                                    "straggler verdict cleared"))
        for p in snap.stragglers:
            if p not in self._demoted:
                self._breach.pop(("recover", p), None)
        return out

    def note_applied(self, d: Decision, now: float) -> None:
        """Fold one APPLIED decision back into controller state: start
        the target's dwell window and advance the codec/demotion maps.
        Split from ``decide`` so a deferred (epoch-fenced) or failed
        actuation neither burns the dwell nor desyncs the maps."""
        if d.lever == "codec":
            self._last_act[("codec", d.target)] = now
            if d.action == "escalate":
                self._level[d.target] = min(
                    self._level.get(d.target, 0) + 1, len(LADDER) - 1)
            elif d.action == "deescalate":
                lvl = self._level.get(d.target, 0) - 1
                if lvl <= 0:
                    self._level.pop(d.target, None)
                else:
                    self._level[d.target] = lvl
            self._breach.pop(("codec", d.target), None)
        elif d.lever == "indegree":
            self._last_act[("indegree", d.target)] = now
            if d.action == "demote":
                self._demoted[d.target] = frozenset(d.arg or ())
                self._breach.pop(("straggler", d.target), None)
            else:
                self._demoted.pop(d.target, None)
                self._breach.pop(("recover", d.target), None)

    # -- sensors ------------------------------------------------------------

    def gather(self, cl=None, now: Optional[float] = None) -> Snapshot:
        """Build the sensor snapshot from the telemetry plane: the
        local store's edge estimators (+ peer-published edges when a
        control plane is attached), the active alert set, the windows'
        EF residual norm, and the step-spread straggler verdict."""
        from . import control_plane as _cp
        from . import heartbeat as _hb
        from . import metrics as _metrics
        from . import timeseries as _ts
        from .state import _global_state

        if now is None:
            now = time.time()
        epoch = _hb.membership_epoch()
        owned: Set[int] = set()
        ef_norm = 0.0
        try:
            st = _global_state()
            for win in list(st.windows.values()):
                owned.update(win.owned)
                ef_norm = max(ef_norm, win.ef_residual_norm())
        except Exception:  # noqa: BLE001 — sensors never raise
            pass
        if not owned:
            owned = {self.rank}
        edges: Dict[Edge, EdgeSample] = {}
        store = _ts.store()
        for name, es in store.edges().items():
            try:
                src_s, dst_s = name.split("->")
                e = (int(src_s), int(dst_s))
            except ValueError:
                continue
            mark = self._edge_mark.get(e)
            self._edge_mark[e] = (now, es.bytes)
            bps = 0.0
            if mark is not None and now > mark[0]:
                bps = max(0.0, (es.bytes - mark[1]) / (now - mark[0]))
            edges[e] = EdgeSample(bps=bps, p99_us=es.percentiles()[1])
        alerts = {name for name, rs in store._rule_state.items()
                  if rs.active}
        stragglers: Set[int] = set()
        if cl is None and _cp.active():
            cl = _cp.client()
        if cl is not None:
            try:
                health = _metrics.read_cluster_health(cl, self.world)
                stragglers = set(health.get("stragglers") or ())
                for p in range(self.world):
                    if p == self.rank:
                        continue
                    doc = _ts.read_rank(cl, p)
                    if not doc:
                        continue
                    for name, row in (doc.get("edges") or {}).items():
                        try:
                            src_s, dst_s = name.split("->")
                            e = (int(src_s), int(dst_s))
                        except ValueError:
                            continue
                        if e not in edges or edges[e].bps == 0.0:
                            edges[e] = EdgeSample(
                                bps=float(row.get("bps") or 0.0),
                                p99_us=row.get("p99_us"))
            except Exception:  # noqa: BLE001 — sensors never raise
                pass
        return Snapshot(now=now, epoch=epoch, rank=self.rank, owned=owned,
                        edges=edges, stragglers=stragglers, alerts=alerts,
                        ef_norm=ef_norm)

    # -- actuation ----------------------------------------------------------

    def _feed_planner(self, snap: Snapshot) -> bool:
        """Plane lever: push measured per-edge wire bytes into every
        hosted window's planner as online overrides. Returns True when
        any planner's size-floor verdict flipped (== a re-plan was
        scheduled); otherwise the ingest is free."""
        from . import timeseries as _ts
        from .state import _global_state

        store = _ts.store()
        per_deposit: Dict[Edge, float] = {}
        for name, es in store.edges().items():
            if not es.deposits:
                continue
            try:
                src_s, dst_s = name.split("->")
                e = (int(src_s), int(dst_s))
            except ValueError:
                continue
            per_deposit[e] = es.bytes / es.deposits
        if not per_deposit:
            return False
        flipped = False
        try:
            st = _global_state()
            for win in list(st.windows.values()):
                planner = getattr(win, "_planner", None)
                if planner is not None:
                    flipped |= planner.ingest_live(per_deposit)
        except Exception:  # noqa: BLE001
            return False
        return flipped

    def _leader(self) -> bool:
        """In-degree moves are actuated by ONE controller (the lowest
        live process index) — every tuner decides, one writes, everybody
        applies through the epoch-fenced demotion document."""
        from . import heartbeat as _hb

        dead = _hb.dead_controllers()
        live = [p for p in range(self.world) if p not in dead]
        return bool(live) and live[0] == self.rank

    def _demote_targets(self, snap: Snapshot, straggler: int) -> List[Edge]:
        """In-edges to drop for a demoted straggler: everything except
        its ``keep_in`` fastest measured in-edges (unmeasured edges rank
        slowest — no data means no recent traffic)."""
        from .state import _global_state

        in_srcs: Set[int] = set()
        try:
            st = _global_state()
            for win in list(st.windows.values()):
                in_srcs.update(win.in_neighbors.get(straggler, ()))
        except Exception:  # noqa: BLE001
            pass
        if not in_srcs:
            return []
        keep = max(1, int(self.rules["keep_in"]))
        ranked = sorted(
            in_srcs,
            key=lambda s: -(snap.edges.get((s, straggler),
                                           EdgeSample()).bps))
        return [(s, straggler) for s in ranked[keep:]]

    def _actuate(self, d: Decision, snap: Snapshot, cl=None) -> bool:
        from .state import _global_state

        if d.lever == "codec":
            src, dst = d.target
            changed = False
            try:
                st = _global_state()
                for win in list(st.windows.values()):
                    if getattr(win, "hosted", False) and src in win.owned:
                        changed |= win.set_edge_codec(src, dst, d.arg)
            except Exception as exc:  # noqa: BLE001
                logger.warning("tuner: codec actuation failed (%s)", exc)
                return False
            return changed
        if d.lever == "indegree":
            if not self._leader():
                return False
            if d.action == "demote":
                drops = self._demote_targets(snap, d.target)
                if not drops:
                    return False
                d.arg = drops
            current = dict(self._demoted)
            if d.action == "demote":
                current[d.target] = frozenset(d.arg)
            else:
                current.pop(d.target, None)
            edges = sorted({e for s in current.values() for e in s})
            return _publish_demotions(cl, edges, snap.epoch)
        return True  # "plane" already actuated through ingest_live

    # -- the tick -----------------------------------------------------------

    def tick(self, cl=None, now: Optional[float] = None) -> List[Decision]:
        """One controller pass: gather -> decide -> (epoch fence) ->
        actuate -> publish. Returns the APPLIED decisions."""
        from . import flight as _flight
        from . import heartbeat as _hb
        from . import metrics as _metrics
        from . import timeseries as _ts

        if now is None:
            now = time.time()
        self._last_tick = now
        snap = self.gather(cl, now)
        decisions = self.decide(snap)
        if self._feed_planner(snap):
            decisions.append(Decision(
                "plane", None, "replan",
                reason="measured edge bytes flipped a size-floor verdict"))
        applied: List[Decision] = []
        for d in decisions:
            # EPOCH FENCE: membership moved since the snapshot was taken
            # (a death, a rejoin) — this decision was derived against a
            # stale edge set. Defer; the next tick re-decides.
            if _hb.membership_epoch() != snap.epoch:
                _metrics.counter("tune.deferred").inc()
                self._record(d, now, "deferred")
                continue
            ok = self._actuate(d, snap, cl)
            if ok:
                self.note_applied(d, now)
                applied.append(d)
                _metrics.counter("tune.decisions").inc()
                _flight.recorder().instant(
                    f"tune.{d.lever}",
                    a=float(d.target if isinstance(d.target, int)
                            else d.target[1] if d.target else -1))
                logger.warning("tune: %s %s %s %s (%s)", d.lever, d.action,
                               d.target, d.arg if d.arg is not None else "",
                               d.reason)
            self._record(d, now, "applied" if ok else "skipped")
        if _ts.enabled():
            _ts.store().series("tune.decisions", "counter", "last").add(
                now, float(_metrics.counter("tune.decisions").value))
        self._publish_trail(cl, now)
        return applied

    def maybe_tick(self, cl=None, now: Optional[float] = None) -> None:
        """Interval-gated entry point (heartbeat tick / optimizer step
        funnel — mirrors ``timeseries.maybe_sample``). Never raises."""
        if not enabled():
            return
        if now is None:
            now = time.time()
        if now - self._last_tick < tune_interval():
            return
        try:
            self.tick(cl, now)
        except Exception as exc:  # noqa: BLE001 — tuning must not take
            logger.debug("tuner tick failed (%s)", exc)  # the job down

    # -- trail / publication ------------------------------------------------

    def _record(self, d: Decision, now: float, status: str) -> None:
        self._decisions.append({
            "t": round(now, 3), "lever": d.lever, "action": d.action,
            "target": list(d.target) if isinstance(d.target, tuple)
            else d.target,
            "arg": [list(e) for e in d.arg]
            if isinstance(d.arg, list) else d.arg,
            "status": status, "reason": d.reason})
        del self._decisions[:-64]

    def _publish_trail(self, cl=None, now: Optional[float] = None) -> None:
        from . import control_plane as _cp

        if cl is None and _cp.active():
            cl = _cp.client()
        if cl is None:
            return
        doc = {
            "rank": self.rank, "t": now,
            "levels": {f"{s}>{t}": LADDER[lvl]
                       for (s, t), lvl in sorted(self._level.items())},
            "demoted": {str(p): sorted([list(e) for e in v])
                        for p, v in sorted(self._demoted.items())},
            "decisions": self._decisions[-16:],
        }
        try:
            cl.put_bytes(TUNE_KEY_FMT.format(rank=self.rank),
                         json.dumps(doc).encode())
        except Exception:  # noqa: BLE001 — telemetry must not raise
            pass


# ---------------------------------------------------------------------------
# Module plumbing: singleton, demotion document, consumer accessor
# ---------------------------------------------------------------------------

_mu = threading.Lock()
_singleton: Optional[Tuner] = None
# demotion view: local mirror (authoritative single-controller, cache
# multi-controller) + the epoch it was read at
_local_demoted: FrozenSet[Edge] = frozenset()
_demote_cache: Dict[str, object] = {"epoch": None, "edges": frozenset()}


def instance() -> Tuner:
    """The process-wide controller (created on first use)."""
    global _singleton
    with _mu:
        if _singleton is None:
            from . import metrics as _metrics

            # controllers: the control plane's world, one rank each
            _singleton = Tuner(_metrics._process_index(),
                               max(1, _metrics._world_size()))
        return _singleton


def reset_for_job() -> None:
    """Fresh controller + demotion view per ``bf.init`` (mirrors
    ``timeseries.reset_for_job``)."""
    global _singleton, _local_demoted
    with _mu:
        _singleton = None
        _local_demoted = frozenset()
        _demote_cache.update(epoch=None, edges=frozenset())


def maybe_tick(cl=None) -> None:
    """The heartbeat/step funnel: no-op unless ``BFT_TUNE=1`` (the
    knob gate runs BEFORE the singleton exists, so the off path touches
    nothing)."""
    if not enabled():
        return
    instance().maybe_tick(cl)


def _publish_demotions(cl, edges: List[Edge], epoch: int) -> bool:
    """Write the job-wide demotion document and bump the membership
    epoch so every optimizer re-plans at the same fence (single-
    controller: just swap the local set — the healed-table cache key
    change applies it on the very next gossip step)."""
    global _local_demoted
    from . import control_plane as _cp
    from . import heartbeat as _hb

    _local_demoted = frozenset(edges)
    if cl is None and _cp.active():
        cl = _cp.client()
    if cl is None:
        return True
    try:
        cl.put_bytes(DEMOTE_KEY, json.dumps(
            {"epoch": epoch, "edges": [list(e) for e in edges]}).encode())
        cl.fetch_add(_hb._EPOCH_KEY, 1)
    except Exception as exc:  # noqa: BLE001
        logger.warning("tuner: demotion publish failed (%s)", exc)
        return False
    _demote_cache.update(epoch=None)  # force re-read at the new epoch
    return True


def demoted_edges() -> FrozenSet[Edge]:
    """The directed edges currently demoted by the controller, as the
    optimizers' healed tables consume them. ``BFT_TUNE=0`` returns
    the empty set with no KV traffic and no singleton — the off path is
    byte-identical to the untuned build (test-pinned). Multi-controller
    reads are cached per membership epoch: demotions only ever change
    together with an epoch bump, so one KV read per epoch suffices."""
    if not enabled():
        return frozenset()
    from . import control_plane as _cp

    if not _cp.active():
        return _local_demoted
    from . import heartbeat as _hb

    ep = _hb.membership_epoch()
    if _demote_cache["epoch"] == ep:
        return _demote_cache["edges"]  # type: ignore[return-value]
    edges = _local_demoted
    try:
        blob = _cp.client().get_bytes(DEMOTE_KEY)
        if blob:
            doc = json.loads(bytes(blob).decode())
            edges = frozenset((int(s), int(d))
                              for s, d in doc.get("edges", []))
    except Exception:  # noqa: BLE001 — keep the previous view on error
        edges = _demote_cache["edges"]  # type: ignore[assignment]
    _demote_cache.update(epoch=ep, edges=edges)
    return edges  # type: ignore[return-value]
