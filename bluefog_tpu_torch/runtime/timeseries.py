"""Live telemetry plane: streaming time series, convergence gauges, alerts.

Counterpart of ``bluefog_tpu/runtime/timeseries.py`` (numpy only; the
``BFT1`` wire form is the JAX package's byte for byte). The metrics
registry answers "what is the value now" and the flight recorder "what
happened, after the fact"; this module keeps the history between them: a
fixed-memory, multi-resolution record of the signals an operator (or the
tuner, ``runtime/tuner.py``) reads as continuous inputs (per-edge wire
bytes/s and deposit-to-drain transit latency, step cadence, consensus
distance and its decay rate, push-sum mass, EF residual, shard-rotation
drift), sampled on the heartbeat tick (or the metrics publisher's, in a
job of one controller) and published as compact deltas under
``bf.ts.<rank>``.

Four pieces:

* **Ring history**: every series keeps RRD-style tiers (1 s / 10 s / 60 s
  resolution) in preallocated numpy rings: recent samples at full
  resolution, hours of history downsampled, memory bounded forever. A
  :meth:`Series.add` is a handful of slotted stores, so sampling is always
  on.

* **Per-edge estimators**, fed from the flight recorder's flow events
  (``edge.<src>.<dst>`` starts, ``drain.<origin>`` finishes): live bytes/s,
  deposit counts, and transit-latency p50/p99 for pairs both sides of
  which this process saw. Recent raw flow digests ride the publication so
  a consumer can match pairs *across* ranks as the postmortem merge does.

* **Convergence gauges**: the window optimizers record the neighborhood
  consensus distance into ``opt.consensus_dist``; the sampler derives the
  effective mixing rate from its decay, plus rate and trend series for
  push-sum mass, EF residual norm and ``win.shard_stale_drops``.

* **Rule engine**: declarative rank-local thresholds (the defaults below,
  overridable by ``BFT_ALERT_RULES``) over any series: a sustained breach
  records a flight instant (``alert.<name>``), bumps ``alert.fired`` and
  publishes under ``bf.alerts.<rank>``; the SLO engine (``BFT_SLO``)
  evaluates multi-window burn rates over the serving series the same way.

Collection is always on unless ``BFT_TS_DISABLE=1``; publication rides the
metrics cadence (``BFT_TS_INTERVAL`` overrides). As in the registry, a rare
lost sample under a race between threads is an acceptable telemetry error.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import knob_env
from .logging import logger

TS_KEY_FMT = "bf.ts.{rank}"
ALERTS_KEY_FMT = "bf.alerts.{rank}"

# Serve clients publish their own time-series docs in a rank band far
# above any trainer world size (``bf.ts.<4096 + cid>``), so client and
# trainer publications never collide and a consumer can tell the planes
# apart by rank alone.
SERVE_TS_RANK_BASE = 4096

_PACK_MAGIC = b"BFT1"

# (resolution seconds, ring slots): ~4 min at 1 s, 1 h at 10 s, 6 h at
# 60 s. Fixed — the whole store is a few hundred KB regardless of job
# length.
TIERS: Tuple[Tuple[float, int], ...] = ((1.0, 256), (10.0, 360),
                                        (60.0, 360))

# Every registry instrument the sampler records each tick:
# (instrument, instrument kind, within-slot aggregation). Counters are
# stored cumulative (consumers and the rule grammar use the derived
# `.rate` series below).
TS_BINDINGS: Tuple[Tuple[str, str, str], ...] = (
    ("opt.step", "gauge", "last"),
    ("opt.consensus_dist", "gauge", "last"),
    ("pushsum.mass", "gauge", "last"),
    ("pushsum.debias_drift", "gauge", "max"),
    ("win.codec.residual_norm", "gauge", "last"),
    ("win.shard_stale_drops", "counter", "last"),
    ("win.deposits_sent", "counter", "last"),
    ("win.deposits_drained", "counter", "last"),
    ("win.drain_bytes", "counter", "last"),
    ("hb.dead_peers", "gauge", "max"),
    ("hb.suspect_peers", "gauge", "max"),
    ("membership.epoch", "gauge", "last"),
    ("cp.repl_lag", "gauge", "max"),
    ("cp.under_replicated", "gauge", "max"),
    ("cp.server.mailbox_records", "gauge", "max"),
    ("cp.server.mailbox_bytes", "gauge", "max"),
    # serving-plane SLO series, recorded by the serve client: absent (and
    # silently skipped) in processes that never serve
    ("slo.requests", "counter", "last"),
    ("slo.shed", "counter", "last"),
    ("slo.breach.serve_p50", "counter", "last"),
    ("slo.breach.serve_p99", "counter", "last"),
    ("slo.breach.serve_avail", "counter", "last"),
    ("slo.breach.serve_staleness", "counter", "last"),
    ("slo.request_p50_us", "gauge", "last"),
    ("slo.request_p99_us", "gauge", "max"),
    ("slo.staleness_p99_ver", "gauge", "max"),
    ("slo.phase.admit.p50_us", "gauge", "last"),
    ("slo.phase.admit.p99_us", "gauge", "last"),
    ("slo.phase.queue.p50_us", "gauge", "last"),
    ("slo.phase.queue.p99_us", "gauge", "last"),
    ("slo.phase.swap_blocked.p50_us", "gauge", "last"),
    ("slo.phase.swap_blocked.p99_us", "gauge", "last"),
    ("slo.phase.linger.p50_us", "gauge", "last"),
    ("slo.phase.linger.p99_us", "gauge", "last"),
    ("slo.phase.decode.p50_us", "gauge", "last"),
    ("slo.phase.decode.p99_us", "gauge", "last"),
    ("slo.phase.reply.p50_us", "gauge", "last"),
    ("slo.phase.reply.p99_us", "gauge", "last"),
    ("trace.requests", "counter", "last"),
)

# Series the sampler computes itself (no registry instrument behind
# them): a closed vocabulary for alert-rule and binding references.
DERIVED_SERIES: Tuple[str, ...] = (
    "opt.mixing_rate",
    "opt.consensus_stalled",
)

# Counters (and the monotone step gauge) that additionally maintain a
# live `<name>.rate` series (units/second between samples).
RATE_SERIES: Tuple[str, ...] = (
    "opt.step",
    "win.shard_stale_drops",
    "win.deposits_sent",
    "win.deposits_drained",
    "win.drain_bytes",
    "slo.requests",
    "slo.shed",
)


# -- ring history ------------------------------------------------------------

class _Tier:
    """One resolution tier: a preallocated (time, value) ring.

    Samples land in the slot ``int(t / res)``; a slot in progress
    aggregates in scalars and is flushed into the ring when time moves to
    the next slot, so memory never grows with job length."""

    __slots__ = ("res", "cap", "t", "v", "n", "_slot", "_agg", "_sum",
                 "_cnt")

    def __init__(self, res: float, cap: int, agg: str) -> None:
        self.res = res
        self.cap = cap
        self.t = np.zeros(cap, np.float64)
        self.v = np.zeros(cap, np.float64)
        self.n = 0
        self._slot = -1
        self._agg = agg
        self._sum = 0.0
        self._cnt = 0

    def add(self, t: float, value: float) -> None:
        slot = int(t / self.res)
        if slot != self._slot:
            if self._slot >= 0:
                i = self.n % self.cap
                self.t[i] = self._slot * self.res
                self.v[i] = self._value()
                self.n += 1
            self._slot = slot
            self._sum = value
            self._cnt = 1
            return
        if self._agg == "last":
            self._sum = value
        elif self._agg == "max":
            self._sum = value if value > self._sum else self._sum
        elif self._agg == "sum":
            self._sum += value
        else:  # mean
            self._sum += value
            self._cnt += 1

    def _value(self) -> float:
        if self._agg == "mean" and self._cnt:
            return self._sum / self._cnt
        return self._sum

    def samples(self) -> Tuple[np.ndarray, np.ndarray]:
        """(times, values) oldest→newest, the in-progress slot included."""
        count = min(self.n, self.cap)
        idx = (self.n - count + np.arange(count)) % self.cap
        t = self.t[idx]
        v = self.v[idx]
        if self._slot >= 0:
            t = np.append(t, self._slot * self.res)
            v = np.append(v, self._value())
        return t, v


class Series:
    """One named series with RRD-style tiers (see module docstring)."""

    __slots__ = ("name", "kind", "agg", "tiers", "last_t", "last_v")

    def __init__(self, name: str, kind: str = "gauge",
                 agg: str = "last") -> None:
        self.name = name
        self.kind = kind
        self.agg = agg
        self.tiers = [_Tier(res, cap, agg) for res, cap in TIERS]
        self.last_t = 0.0
        self.last_v = float("nan")

    def add(self, t: float, value: float) -> None:
        """The hot path: one slotted add per tier plus two scalar
        stores — no allocation, no lock (a rare torn sample is an
        acceptable telemetry error, same trade as the registry)."""
        value = float(value)
        self.tiers[0].add(t, value)
        self.tiers[1].add(t, value)
        self.tiers[2].add(t, value)
        self.last_t = t
        self.last_v = value

    def latest(self) -> Tuple[float, float]:
        return self.last_t, self.last_v

    def window(self, span_sec: float) -> Tuple[np.ndarray, np.ndarray]:
        """Samples covering the last ``span_sec``: of the three tiers,
        the one holding the MOST samples inside the window (finer tiers
        win ties). A coarse tier only wins when the finer rings have
        already evicted the window's early samples."""
        now = self.last_t
        best = None
        for tier in self.tiers:
            tt, tv = tier.samples()
            keep = tt >= now - span_sec
            tt, tv = tt[keep], tv[keep]
            covered = float(tt[-1] - tt[0]) if len(tt) else -1.0
            # strictly greater: finer tiers (iterated first) win ties
            if best is None or covered > best[0]:
                best = (covered, tt, tv)
        return best[1], best[2]

    def rate(self, span_sec: float = 60.0) -> Optional[float]:
        """Average units/second across the window (for counters: the
        cumulative-value delta over elapsed time)."""
        t, v = self.window(span_sec)
        if len(t) < 2 or t[-1] <= t[0]:
            return None
        return float((v[-1] - v[0]) / (t[-1] - t[0]))

    def trend(self, span_sec: float = 120.0) -> Optional[float]:
        """Least-squares slope (units/second) over the window — the
        mass-drift / residual-norm trend signal."""
        t, v = self.window(span_sec)
        if len(t) < 3:
            return None
        t = t - t[0]
        denom = float(np.sum((t - t.mean()) ** 2))
        if denom <= 0:
            return None
        return float(np.sum((t - t.mean()) * (v - v.mean())) / denom)


# -- per-edge live estimators ------------------------------------------------

_TRANSIT_RING = 128


class EdgeStats:
    """Live per-edge estimator fed from flow events."""

    __slots__ = ("bytes", "deposits", "transit_us", "_tn", "_pub_bytes",
                 "_pub_t")

    def __init__(self) -> None:
        self.bytes = 0.0
        self.deposits = 0
        self.transit_us = np.zeros(_TRANSIT_RING, np.float64)
        self._tn = 0
        self._pub_bytes = 0.0
        self._pub_t = 0.0

    def on_start(self, nbytes: float) -> None:
        self.bytes += nbytes
        self.deposits += 1

    def on_transit(self, us: float) -> None:
        self.transit_us[self._tn % _TRANSIT_RING] = us
        self._tn += 1

    def percentiles(self) -> Tuple[Optional[float], Optional[float]]:
        n = min(self._tn, _TRANSIT_RING)
        if n == 0:
            return None, None
        window = self.transit_us[:n]
        return (float(np.percentile(window, 50)),
                float(np.percentile(window, 99)))

    def bps_since_publish(self, now: float) -> float:
        dt = now - self._pub_t if self._pub_t else 0.0
        bps = (self.bytes - self._pub_bytes) / dt if dt > 0 else 0.0
        self._pub_bytes = self.bytes
        self._pub_t = now
        return bps


# -- alert rules -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative threshold: fire when ``series <op> threshold``
    holds for at least ``for_sec`` seconds of samples."""

    name: str
    series: str
    op: str          # one of > >= < <=
    threshold: float
    for_sec: float
    doc: str = ""


# Default rank-local rules (grammar: parse_rules). Every referenced series
# exists as a binding, a derived `.rate`, or a derived gauge.
DEFAULT_RULES: Tuple[Rule, ...] = (
    Rule("straggler", "opt.step.rate", "<=", 0.0, 30.0,
         "no optimizer-step progress while peers keep publishing"),
    Rule("mass_drift", "pushsum.debias_drift", ">", 0.5, 30.0,
         "push-sum de-bias scalar wandering far from 1"),
    Rule("wal_lag", "cp.repl_lag", ">", 4096.0, 15.0,
         "control-plane WAL replication lagging the successor"),
    Rule("mailbox_depth", "cp.server.mailbox_records", ">", 50000.0, 15.0,
         "served mailboxes backing up (owner not draining)"),
    Rule("consensus_stall", "opt.consensus_stalled", ">", 0.5, 60.0,
         "consensus distance positive but no longer decaying"),
    Rule("shard_drift", "win.shard_stale_drops.rate", ">", 0.0, 30.0,
         "sustained shard-rotation drift (a controller's comm rounds "
         "desynced)"),
)

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


def parse_rules(spec: Optional[str]) -> Tuple[Rule, ...]:
    """Rules = defaults overridden/extended by ``BFT_ALERT_RULES``.

    Grammar (comma-separated):
      ``name:series>value:for=SEC``  — add or replace a rule by name
      ``name:off``                   — disable a default rule
    Example: ``wal_lag:cp.repl_lag>100:for=5,mass_drift:off``.
    A malformed term is warned about and skipped (telemetry config must
    never take a job down)."""
    rules = {r.name: r for r in DEFAULT_RULES}
    if not spec:
        return tuple(rules.values())
    for term in spec.split(","):
        term = term.strip()
        if not term:
            continue
        parts = term.split(":")
        name = parts[0].strip()
        if len(parts) == 2 and parts[1].strip() == "off":
            rules.pop(name, None)
            continue
        try:
            cond = parts[1].strip()
            for op in (">=", "<=", ">", "<"):
                if op in cond:
                    series, thr = cond.split(op, 1)
                    break
            else:
                raise ValueError("no comparison operator")
            for_sec = 0.0
            for extra in parts[2:]:
                k, _, v = extra.partition("=")
                if k.strip() == "for":
                    for_sec = float(v)
            rules[name] = Rule(name, series.strip(), op, float(thr),
                               for_sec)
        except (ValueError, IndexError) as exc:
            logger.warning("BFT_ALERT_RULES: skipping malformed term "
                           "%r (%s)", term, exc)
    return tuple(rules.values())


class _RuleState:
    __slots__ = ("breach_since", "active", "value")

    def __init__(self) -> None:
        self.breach_since: Optional[float] = None
        self.active = False
        self.value = 0.0


# -- SLO objectives ----------------------------------------------------------

# The closed kind vocabulary keeps every derived series name static.
SLO_KINDS = ("serve_p50", "serve_p99", "serve_avail", "serve_staleness")

# slow burn window = fast window x this (the classic 5m/1h pairing)
SLO_SLOW_FACTOR = 12.0


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative serving objective.

    ``target`` is in the kind's native unit: microseconds for the
    latency kinds, snapshot versions for staleness, percent for
    availability. ``budget`` is the allowed error fraction the burn rate
    is measured against (p99 -> 1%, p50 -> 50%, staleness -> 1%,
    availability -> 1 - target)."""

    name: str
    target: float
    window_s: float
    budget: float


def _parse_duration_s(tok: str) -> float:
    tok = tok.strip().lower()
    for suf, mult in (("ms", 1e-3), ("us", 1e-6), ("h", 3600.0),
                      ("m", 60.0), ("s", 1.0)):
        if tok.endswith(suf):
            return float(tok[:-len(suf)]) * mult
    return float(tok)


def parse_slos(spec) -> Tuple[SLO, ...]:
    """``BFT_SLO`` grammar — comma-separated ``kind:target@window``:

      ``serve_p99:50ms@5m``       at most 1% of requests slower than
                                  50 ms, burn measured over a 5 m fast
                                  window (and a 12x slow window)
      ``serve_p50:2ms@1m``        at most 50% slower than 2 ms
      ``serve_avail:99.9@1h``     at least 99.9% of requests admitted
      ``serve_staleness:3ver@5m`` at most 1% answered more than 3
                                  snapshot versions behind the fence

    A malformed term is warned about and skipped (telemetry config must
    never take a job down); the window defaults to 5 m when omitted."""
    out: List[SLO] = []
    if not spec:
        return tuple(out)
    for term in str(spec).split(","):
        term = term.strip()
        if not term:
            continue
        try:
            kind, _, rest = term.partition(":")
            kind = kind.strip()
            if kind not in SLO_KINDS or not rest:
                raise ValueError(f"unknown SLO kind {kind!r}")
            tgt, _, win = rest.partition("@")
            window_s = max(1.0, _parse_duration_s(win)) if win else 300.0
            tgt = tgt.strip().lower()
            if kind == "serve_avail":
                pct = float(tgt.rstrip("%"))
                target, budget = pct, max(1e-6, 1.0 - pct / 100.0)
            elif kind == "serve_staleness":
                target = float(tgt[:-3]) if tgt.endswith("ver") \
                    else float(tgt)
                budget = 0.01
            else:
                target = _parse_duration_s(tgt) * 1e6  # -> microseconds
                budget = 0.5 if kind == "serve_p50" else 0.01
            out.append(SLO(kind, target, window_s, budget))
        except (ValueError, IndexError) as exc:
            logger.warning("BFT_SLO: skipping malformed term %r (%s)",
                           term, exc)
    return tuple(out)


# -- the store ---------------------------------------------------------------

_PENDING_FLOWS_CAP = 4096     # unmatched starts retained for matching
_FLOW_DIGEST_CAP = 256        # raw flow events shipped per publication
_SCAN_CAP = 8192              # flight-ring events processed per tick
_FULL_EVERY = 16              # every Nth publication carries tier history


class TimeSeriesStore:
    """Process-global store: series + edge estimators + rule engine +
    the ``bf.ts.<rank>`` publisher."""

    def __init__(self) -> None:
        self._mu = threading.Lock()      # series creation only
        self._series: Dict[str, Series] = {}
        self._edges: Dict[str, EdgeStats] = {}
        self._pending: Dict[int, Tuple[float, float, int, int]] = {}
        self._flow_starts: List[list] = []    # publication digest (delta)
        self._flow_finishes: List[list] = []
        self._scan_cursor = 0
        self._last_sample = 0.0
        self._last_publish = 0.0
        self._last_counter: Dict[str, Tuple[float, float]] = {}
        self._pub_mark: Dict[str, float] = {}  # series -> last shipped t
        self._seq = 0
        self._rules = parse_rules(knob_env("BFT_ALERT_RULES"))
        self._rule_state = {r.name: _RuleState() for r in self._rules}
        self._slos = parse_slos(knob_env("BFT_SLO"))
        self._slo_state = {o.name: _RuleState() for o in self._slos}
        self._slo_burn = float(knob_env("BFT_SLO_BURN"))
        # raw (t, v) consensus samples for the mixing-rate fit: the 1 s
        # tier collapses several same-second samples into one slot, and
        # the fit wants every point
        self._consensus_raw: List[Tuple[float, float]] = []

    # -- series ------------------------------------------------------------

    def series(self, name: str, kind: str = "gauge",
               agg: str = "last") -> Series:
        s = self._series.get(name)
        if s is None:
            with self._mu:
                s = self._series.setdefault(name, Series(name, kind, agg))
        return s

    def names(self) -> List[str]:
        return sorted(self._series)

    def edges(self) -> Dict[str, EdgeStats]:
        return self._edges

    # -- sampling ----------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> None:
        """One sampling pass: registry bindings, derived rates/gauges,
        flow-event scan, rule evaluation. Bounded work per call; never
        raises (telemetry must not take the tick down)."""
        from . import metrics as _metrics

        if now is None:
            now = time.time()
        reg = _metrics.registry()
        for name, kind, agg in TS_BINDINGS:
            if name.startswith("cp.server."):
                continue  # server stats handled as a batch below
            inst = reg._gauges.get(name)
            v = None
            if inst is not None:
                v = inst.value
            else:
                c = reg._counters.get(name)
                if c is not None:
                    v = float(c.value)
            if v is None:
                continue
            self.series(name, kind, agg).add(now, v)
            if name in RATE_SERIES:
                self._record_rate(name, now, v)
        try:
            srv = _metrics._server_stats_flat()
        except Exception:  # noqa: BLE001 — telemetry must not raise
            srv = {}
        for name, kind, agg in TS_BINDINGS:
            if name.startswith("cp.server.") and name in srv:
                self.series(name, kind, agg).add(now, srv[name])
        self._scan_flows(now)
        self._derive(now)
        self._evaluate_rules(now)
        self._evaluate_slos(now)
        self._last_sample = now

    def _record_rate(self, name: str, now: float, v: float) -> None:
        prev = self._last_counter.get(name)
        self._last_counter[name] = (now, v)
        if prev is None or now <= prev[0]:
            return
        self.series(f"{name}.rate", "gauge", "mean").add(
            now, (v - prev[1]) / (now - prev[0]))

    def _scan_flows(self, now: float) -> None:
        """Feed edge estimators from the flight ring's flow events written
        since the last pass (no extra hot-path hook: the events the
        recorder already emits ARE the sensor)."""
        from . import flight as _flight

        rec = _flight.recorder()
        n = getattr(rec, "_n", 0)
        if n <= self._scan_cursor:
            self._scan_cursor = min(self._scan_cursor, n)
            return
        cap = getattr(rec, "capacity", 0)
        if not cap:
            return
        start = max(self._scan_cursor, n - cap, n - _SCAN_CAP)
        names = rec._names
        for i in range(start, n):
            j = i & rec._mask
            kind = int(rec._kind[j])
            if kind != _flight.FLOW_S and kind != _flight.FLOW_F:
                continue
            nid = int(rec._name[j])
            name = names[nid] if 0 <= nid < len(names) else ""
            t_us = rec._wall_us(int(rec._t[j]))
            fid = int(rec._b[j])
            nbytes = float(rec._a[j])
            if kind == _flight.FLOW_S and name.startswith("edge."):
                try:
                    _, src, dst = name.split(".")
                    src_i, dst_i = int(src), int(dst)
                except ValueError:
                    continue
                edge = f"{src_i}->{dst_i}"
                st = self._edges.get(edge)
                if st is None:
                    st = self._edges[edge] = EdgeStats()
                st.on_start(nbytes)
                if len(self._pending) < _PENDING_FLOWS_CAP:
                    self._pending[fid] = (t_us, nbytes, src_i, dst_i)
                if len(self._flow_starts) < _FLOW_DIGEST_CAP:
                    self._flow_starts.append(
                        [fid, int(t_us), int(nbytes), src_i, dst_i])
            elif kind == _flight.FLOW_F:
                pend = self._pending.pop(fid, None)
                if pend is not None:
                    t0, _, src_i, dst_i = pend
                    st = self._edges.get(f"{src_i}->{dst_i}")
                    if st is not None and t_us >= t0:
                        st.on_transit(t_us - t0)
                if len(self._flow_finishes) < _FLOW_DIGEST_CAP:
                    self._flow_finishes.append([fid, int(t_us)])
        self._scan_cursor = n

    def _derive(self, now: float) -> None:
        """Derived convergence gauges: effective mixing rate fit from the
        consensus-distance decay, plus the stall flag the rule engine
        thresholds (distance positive but no longer shrinking)."""
        from . import metrics as _metrics

        d = self._series.get("opt.consensus_dist")
        if d is None:
            return
        if not self._consensus_raw or \
                d.last_t > self._consensus_raw[-1][0]:
            self._consensus_raw.append((d.last_t, d.last_v))
            del self._consensus_raw[:-64]
        # fit points: the 1 s tier window, falling back to the raw ring
        # when several samples collapsed into one wall-second slot
        t, v = d.window(TIERS[0][0] * 16)
        pts = [(float(a), float(b)) for a, b in zip(t, v) if b > 0]
        if len(pts) < 3:
            pts = [(a, b) for a, b in self._consensus_raw
                   if a >= now - TIERS[0][0] * 16 and b > 0]
        rate = None
        if len(pts) >= 3:
            tt = np.asarray([a for a, _ in pts])
            vv = np.asarray([b for _, b in pts])
            span = tt[-1] - tt[0]
            if span > 0:
                # geometric decay per second, fit on the log values
                slope = np.polyfit(tt - tt[0], np.log(vv), 1)[0]
                rate = float(math.exp(np.clip(slope, -20.0, 2.0)))
        if rate is not None:
            self.series("opt.mixing_rate", "gauge", "last").add(now, rate)
            _metrics.gauge("opt.mixing_rate").set(rate)
        stalled = 1.0 if (rate is not None and rate >= 0.999
                          and d.last_v > 1e-9) else 0.0
        self.series("opt.consensus_stalled", "gauge", "max").add(
            now, stalled)

    def _evaluate_rules(self, now: float) -> None:
        from . import flight as _flight
        from . import metrics as _metrics

        for rule in self._rules:
            s = self._series.get(rule.series)
            if s is None or s.last_t == 0.0:
                continue
            st = self._rule_state[rule.name]
            st.value = s.last_v
            if _OPS[rule.op](s.last_v, rule.threshold):
                if st.breach_since is None:
                    st.breach_since = now
                if not st.active and \
                        now - st.breach_since >= rule.for_sec:
                    st.active = True
                    _metrics.counter("alert.fired").inc()
                    _flight.recorder().instant(f"alert.{rule.name}",
                                               a=s.last_v)
                    logger.warning(
                        "alert %s: %s %s %g held for %.0f s (value %g)",
                        rule.name, rule.series,
                        rule.op, rule.threshold, rule.for_sec, s.last_v)
            else:
                if st.active:
                    _flight.recorder().instant(
                        f"alert.{rule.name}.clear", a=s.last_v)
                st.breach_since = None
                st.active = False

    def _window_delta(self, name: str, span: float) -> Optional[float]:
        s = self._series.get(name)
        if s is None:
            return None
        t, v = s.window(span)
        if len(t) < 2:
            return None
        return float(v[-1] - v[0])

    def _evaluate_slos(self, now: float) -> None:
        """Multi-window burn-rate evaluation: for each
        objective, the error fraction over the fast (declared) window
        and a ``SLO_SLOW_FACTOR``x slow window, each divided by the
        error budget. ``alert.slo.<kind>`` fires when BOTH burn rates
        exceed ``BFT_SLO_BURN`` — a fast-only spike doesn't page, a
        long-gone burst aging through the slow window alone doesn't
        either — and clears as soon as the fast window recovers. The
        windows do the sustaining, so there is no ``for_sec`` here."""
        if not self._slos:
            return
        from . import flight as _flight
        from . import metrics as _metrics

        for obj in self._slos:
            err_series = "slo.shed" if obj.name == "serve_avail" \
                else f"slo.breach.{obj.name}"
            burns = {}
            for tag, win in (("fast", obj.window_s),
                             ("slow", obj.window_s * SLO_SLOW_FACTOR)):
                dreq = self._window_delta("slo.requests", win)
                derr = self._window_delta(err_series, win)
                err = (derr / dreq) if dreq and derr is not None else 0.0
                burns[tag] = err / obj.budget
                self.series(f"slo.burn.{obj.name}.{tag}", "gauge",
                            "last").add(now, burns[tag])
            # error budget left in the slow window; <= 0 is exhaustion
            # (the --status --strict exit-2 signal)
            self.series(f"slo.budget.{obj.name}", "gauge", "last").add(
                now, 1.0 - burns["slow"])
            st = self._slo_state[obj.name]
            st.value = burns["fast"]
            if burns["fast"] >= self._slo_burn and \
                    burns["slow"] >= self._slo_burn:
                if st.breach_since is None:
                    st.breach_since = now
                if not st.active:
                    st.active = True
                    _metrics.counter("alert.fired").inc()
                    _flight.recorder().instant(f"alert.slo.{obj.name}",
                                               a=burns["fast"])
                    logger.warning(
                        "SLO alert slo.%s: burn rate fast %.2f / slow "
                        "%.2f over threshold %.2f (budget %.4f)",
                        obj.name, burns["fast"],
                        burns["slow"], self._slo_burn, obj.budget)
            elif burns["fast"] < self._slo_burn:
                if st.active:
                    _flight.recorder().instant(
                        f"alert.slo.{obj.name}.clear", a=burns["fast"])
                st.breach_since = None
                st.active = False

    def slo_status(self) -> List[dict]:
        """Per-objective burn/budget snapshot (``--top``'s SLO section
        and the ``--status --strict`` budget-exhaustion finding)."""
        out = []
        for obj in self._slos:
            def _last(name):
                s = self._series.get(name)
                return s.last_v if s is not None and s.last_t else None

            out.append({
                "name": obj.name, "target": obj.target,
                "window_s": obj.window_s, "budget": obj.budget,
                "burn_fast": _last(f"slo.burn.{obj.name}.fast"),
                "burn_slow": _last(f"slo.burn.{obj.name}.slow"),
                "budget_remaining": _last(f"slo.budget.{obj.name}"),
                "active": self._slo_state[obj.name].active,
            })
        return out

    def active_alerts(self) -> List[dict]:
        out = []
        for rule in self._rules:
            st = self._rule_state[rule.name]
            if st.active:
                out.append({"name": rule.name, "series": rule.series,
                            "since": st.breach_since, "value": st.value})
        for obj in self._slos:
            st = self._slo_state[obj.name]
            if st.active:
                out.append({"name": f"slo.{obj.name}",
                            "series": f"slo.burn.{obj.name}.fast",
                            "since": st.breach_since, "value": st.value})
        return out

    # -- publication -------------------------------------------------------

    def build_doc(self, rank: int, inc: int, now: float,
                  interval: float) -> dict:
        """The ``bf.ts.<rank>`` document: per-series samples newer than
        the previous publication (delta encoding — timestamps ship as
        millisecond offsets), the per-edge estimator summaries, the raw
        flow digests for cross-rank matching, active alerts, and — every
        ``_FULL_EVERY``-th publication — the downsampled tier history so
        a late-joining consumer still gets the past."""
        full = (self._seq % _FULL_EVERY) == 0
        series: Dict[str, dict] = {}
        hist: Dict[str, dict] = {}
        latest: Dict[str, list] = {}
        for name in sorted(self._series):
            s = self._series[name]
            if s.last_t:
                # constant-size current-value row: a consumer reading
                # only the newest blob (late joiner, one-shot probe)
                # still sees every series even when its delta is empty
                latest[name] = [int(s.last_t * 1000),
                                float(f"{s.last_v:.6g}")]
            t, v = s.tiers[0].samples()
            mark = self._pub_mark.get(name, 0.0)
            keep = t > mark
            if np.any(keep):
                tt = t[keep]
                series[name] = {
                    "kind": s.kind,
                    "t0_ms": int(tt[0] * 1000),
                    "dt_ms": np.diff(tt * 1000).astype(np.int64).tolist(),
                    "v": [float(f"{x:.6g}") for x in v[keep]],
                }
                self._pub_mark[name] = float(tt[-1])
            if full:
                htiers = {}
                for tier in s.tiers[1:]:
                    ht, hv = tier.samples()
                    if len(ht):
                        htiers[str(int(tier.res))] = [
                            [int(x * 1000) for x in ht],
                            [float(f"{x:.6g}") for x in hv]]
                if htiers:
                    hist[name] = htiers
        edges = {}
        for edge in sorted(self._edges):
            st = self._edges[edge]
            p50, p99 = st.percentiles()
            edges[edge] = {"bytes": st.bytes, "deposits": st.deposits,
                           "bps": st.bps_since_publish(now),
                           "p50_us": p50, "p99_us": p99}
        starts, self._flow_starts = self._flow_starts, []
        finishes, self._flow_finishes = self._flow_finishes, []
        doc = {
            "schema": 1,
            "rank": rank,
            "inc": inc,
            "ts": now,
            "seq": self._seq,
            "interval": interval,
            "series": series,
            "latest": latest,
            "edges": edges,
            "flows": {"starts": starts, "finishes": finishes},
            "alerts": self.active_alerts(),
        }
        if hist:
            doc["hist"] = hist
        self._seq += 1
        return doc


def pack_doc(doc: dict) -> bytes:
    """Wire form: magic + zlib'd JSON (the JAX package's, byte for byte:
    readable by either package, and by a reader with neither)."""
    return _PACK_MAGIC + zlib.compress(
        json.dumps(doc, separators=(",", ":")).encode(), level=6)


def unpack_doc(blob: bytes) -> dict:
    if len(blob) < 4 or blob[:4] != _PACK_MAGIC:
        raise ValueError("not a bluefog time-series blob (bad magic)")
    return json.loads(zlib.decompress(blob[4:]).decode())


# -- process-global wiring ---------------------------------------------------

_store_mu = threading.Lock()
_store: Optional[TimeSeriesStore] = None


def store() -> TimeSeriesStore:
    global _store
    s = _store
    if s is None:
        with _store_mu:
            if _store is None:
                _store = TimeSeriesStore()
            s = _store
    return s


def reset_for_job() -> None:
    """Fresh store per ``bf.init`` (re-reads the rule/disable knobs)."""
    global _store
    with _store_mu:
        _store = TimeSeriesStore()


def enabled() -> bool:
    return not knob_env("BFT_TS_DISABLE")


def publish_interval() -> float:
    """Publication cadence: ``BFT_TS_INTERVAL``, else the metrics
    cadence, else a 5 s default when a control plane is attached."""
    raw = knob_env("BFT_TS_INTERVAL")
    if raw is not None:
        return max(0.0, float(raw))
    from . import metrics as _metrics

    return _metrics.publish_interval() or 5.0


_SAMPLE_MIN_GAP = 0.9  # seconds — the 1 s tier's natural cadence


def maybe_sample(cl=None, force: bool = False,
                 publish: Optional[bool] = None) -> None:
    """Sampling entry point: the heartbeat tick, the metrics publisher
    thread, and the window optimizers' step path all funnel here. A
    monotonic-time gate keeps the cadence ~1 Hz no matter how often it is
    called; publication piggybacks on its own interval."""
    if not enabled():
        return
    s = store()
    now = time.time()
    if not force and now - s._last_sample < _SAMPLE_MIN_GAP:
        return
    try:
        s.sample(now)
    except Exception as exc:  # noqa: BLE001 — observability never raises
        logger.debug("timeseries sample failed (%s)", exc)
        return
    interval = publish_interval()
    want_pub = publish if publish is not None else (
        interval > 0 and now - s._last_publish >= interval)
    if want_pub:
        publish_now(cl, now=now)


def publish_now(cl=None, now: Optional[float] = None) -> Optional[dict]:
    """Publish one ``bf.ts.<rank>`` delta (and ``bf.alerts.<rank>`` when
    alerts are active). Returns the doc, or None when no client."""
    from . import control_plane as _cp
    from . import metrics as _metrics

    if not enabled():
        return None
    s = store()
    if now is None:
        now = time.time()
    if cl is None and _cp.active():
        cl = _cp.client()
    if cl is None:
        return None
    rank = _metrics._process_index()
    try:
        inc = _cp.incarnation()
    except Exception:  # noqa: BLE001
        inc = 0
    doc = s.build_doc(rank, inc, now, publish_interval())
    try:
        cl.put_bytes(TS_KEY_FMT.format(rank=rank), pack_doc(doc))
        if doc["alerts"]:
            cl.put_bytes(ALERTS_KEY_FMT.format(rank=rank),
                         zlib.compress(json.dumps(doc["alerts"]).encode()))
        s._last_publish = now
    except Exception as exc:  # noqa: BLE001 — telemetry must not raise
        logger.debug("timeseries publish failed (%s)", exc)
        return None
    return doc


# -- consumer side (a raw client) --------------------------------------------

def read_rank(cl, rank: int) -> Optional[dict]:
    """One rank's latest published doc (None when absent/unreadable)."""
    try:
        blob = cl.get_bytes(TS_KEY_FMT.format(rank=rank))
    except (OSError, RuntimeError):
        return None
    if not blob:
        return None
    try:
        return unpack_doc(bytes(blob))
    except (ValueError, zlib.error, json.JSONDecodeError):
        return None


class HistoryAccumulator:
    """Consumer-side merge of successive delta publications: per-rank
    series history, cross-rank flow matching (deposit on rank A, drain
    on rank B), and silent-rank detection."""

    def __init__(self, cap: int = 2048) -> None:
        self.cap = cap
        self.series: Dict[Tuple[int, str], List[Tuple[float, float]]] = {}
        self.edges: Dict[int, dict] = {}
        self.alerts: Dict[int, list] = {}
        self.meta: Dict[int, dict] = {}
        self._starts: Dict[int, Tuple[float, float, int, int]] = {}
        self.transits: Dict[str, List[float]] = {}
        self._seen_seq: Dict[int, int] = {}

    def update(self, rank: int, doc: dict) -> None:
        if doc is None:
            return
        if self._seen_seq.get(rank) == doc.get("seq"):
            return  # same publication polled twice
        self._seen_seq[rank] = doc.get("seq", -1)
        self.meta[rank] = {"ts": doc.get("ts", 0.0),
                           "inc": doc.get("inc", 0),
                           "interval": doc.get("interval", 5.0),
                           "seq": doc.get("seq", 0)}
        for name, rec in doc.get("series", {}).items():
            key = (rank, name)
            hist = self.series.setdefault(key, [])
            t = rec.get("t0_ms", 0) / 1000.0
            vals = rec.get("v", [])
            dts = [0] + rec.get("dt_ms", [])
            for dt, v in zip(dts, vals):
                t += dt / 1000.0
                hist.append((t, v))
            del hist[:-self.cap]
        for name, tiers in doc.get("hist", {}).items():
            key = (rank, name)
            if key in self.series:
                continue  # live deltas already cover it
            finest = min(tiers, key=lambda r: int(r))
            ts, vs = tiers[finest]
            self.series[key] = [(tm / 1000.0, v)
                                for tm, v in zip(ts, vs)][-self.cap:]
        for name, (t_ms, v) in doc.get("latest", {}).items():
            key = (rank, name)
            hist = self.series.setdefault(key, [])
            t = t_ms / 1000.0
            if not hist or t > hist[-1][0]:
                hist.append((t, v))
                del hist[:-self.cap]
        self.edges[rank] = doc.get("edges", {})
        self.alerts[rank] = doc.get("alerts", [])
        flows = doc.get("flows", {})
        for fid, t_ms, nbytes, src, dst in flows.get("starts", []):
            if len(self._starts) < _PENDING_FLOWS_CAP:
                self._starts[fid] = (t_ms, nbytes, src, dst)
        for fid, t_ms in flows.get("finishes", []):
            st = self._starts.pop(fid, None)
            if st is not None and t_ms >= st[0]:
                edge = f"{st[2]}->{st[3]}"
                self.transits.setdefault(edge, []).append(t_ms - st[0])

    def latest(self, rank: int, name: str) -> Optional[float]:
        hist = self.series.get((rank, name))
        return hist[-1][1] if hist else None

    def values(self, rank: int, name: str, last: int = 32) -> List[float]:
        hist = self.series.get((rank, name), [])
        return [v for _, v in hist[-last:]]

    def silent_ranks(self, world: int,
                     now: Optional[float] = None) -> List[int]:
        """Ranks that never published or whose stream went stale (> 3
        publish intervals + a floor) — the SIGKILL detector."""
        if now is None:
            now = time.time()
        out = []
        for r in range(world):
            m = self.meta.get(r)
            if m is None:
                out.append(r)
                continue
            stale_after = max(3.0 * m.get("interval", 5.0), 6.0)
            if now - m["ts"] > stale_after:
                out.append(r)
        return out

    def edge_transit(self, edge: str) -> Tuple[Optional[float],
                                               Optional[float]]:
        """Cross-rank matched transit (p50, p99) µs for an edge, merged
        with the ranks' own locally-matched estimates."""
        samples = list(self.transits.get(edge, []))
        for edges in self.edges.values():
            st = edges.get(edge)
            if st and st.get("p50_us") is not None:
                samples.append(st["p50_us"])
        if not samples:
            return None, None
        arr = np.asarray(samples, np.float64)
        return (float(np.percentile(arr, 50)),
                float(np.percentile(arr, 99)))


# -- rendering (the launcher's `--top`) --------------------------------------

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 16) -> str:
    vals = [v for v in values[-width:] if v == v]  # drop NaN
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[0] * len(vals)
    return "".join(_SPARK[int((v - lo) / (hi - lo) * (len(_SPARK) - 1))]
                   for v in vals)


def _fmt(v: Optional[float], spec: str = ".3g") -> str:
    if v is None or (isinstance(v, float) and v != v):
        return "-"
    return format(v, spec)


def format_top(acc: HistoryAccumulator, world: int,
               now: Optional[float] = None) -> str:
    """The ``--top`` frame: per-rank table, per-edge matrix,
    sparklines, alerts, silent ranks — plain text, ANSI-free (the
    launcher owns screen clearing)."""
    if now is None:
        now = time.time()
    silent = set(acc.silent_ranks(world, now))
    lines = [f"bluefog cluster — {world} rank(s), "
             f"{time.strftime('%H:%M:%S', time.localtime(now))}"]
    lines.append(
        f"  {'rank':>4} {'step':>8} {'step/s':>7} {'consensus':>10} "
        f"{'mix':>6} {'mass':>8} {'ef_norm':>8} {'drops/s':>8} "
        f"{'trend':<18} status")
    for r in range(world):
        if r in silent and r not in acc.meta:
            lines.append(f"  {r:>4} {'-':>8} {'-':>7} {'-':>10} {'-':>6} "
                         f"{'-':>8} {'-':>8} {'-':>8} {'':<18} SILENT "
                         "(never published)")
            continue
        step = acc.latest(r, "opt.step")
        rate = acc.latest(r, "opt.step.rate")
        cons = acc.latest(r, "opt.consensus_dist")
        mix = acc.latest(r, "opt.mixing_rate")
        mass = acc.latest(r, "pushsum.mass")
        ef = acc.latest(r, "win.codec.residual_norm")
        drops = acc.latest(r, "win.shard_stale_drops.rate")
        spark = sparkline(acc.values(
            r, "opt.consensus_dist" if cons is not None else "opt.step"))
        status = []
        if r in silent:
            status.append("SILENT")
        for a in acc.alerts.get(r, []):
            status.append(f"ALERT:{a['name']}")
        lines.append(
            f"  {r:>4} {_fmt(step, '.0f'):>8} {_fmt(rate, '.2f'):>7} "
            f"{_fmt(cons):>10} {_fmt(mix, '.3f'):>6} {_fmt(mass):>8} "
            f"{_fmt(ef):>8} {_fmt(drops, '.2f'):>8} {spark:<18} "
            + (" ".join(status) if status else "ok"))
    if silent:
        lines.append(f"  SILENT rank(s): {sorted(silent)} — no "
                     "bf.ts publication within 3 intervals (killed or "
                     "wedged)")
    # per-edge matrix: union of every rank's estimators
    edges: Dict[str, dict] = {}
    for r, per in sorted(acc.edges.items()):
        for edge, st in per.items():
            cur = edges.setdefault(edge, {"bps": 0.0, "deposits": 0,
                                          "bytes": 0.0})
            cur["bps"] += st.get("bps") or 0.0
            cur["deposits"] += st.get("deposits") or 0
            cur["bytes"] += st.get("bytes") or 0.0
    if edges:
        lines.append("  edges (live):")
        for edge in sorted(edges):
            st = edges[edge]
            p50, p99 = acc.edge_transit(edge)
            lines.append(
                f"    {edge:<8} {st['bps'] / 1e6:8.2f} MB/s  "
                f"{st['deposits']:6d} deposits  "
                f"transit p50 {_fmt(p50 and p50 / 1e3, '.2f')} ms  "
                f"p99 {_fmt(p99 and p99 / 1e3, '.2f')} ms")
    return "\n".join(lines)
