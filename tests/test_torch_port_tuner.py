"""Port vs JAX: the self-tuning controller and the in-degree topology lever.

The counterparts of ``tests/test_tuner.py``'s fourteen decision, tick and
trail tests run the port's ``runtime/tuner.py``: ``Tuner.decide`` is a pure
function of (Snapshot, hysteresis state), so every row of the decision
table (slow-edge codec escalation, pressure de-escalation, straggler
demotion, recovery promotion), the epoch fence, the dwell and the
sustained-breach gates run over synthetic snapshots with no control plane
and no window; ``BFT_TUNE=0`` touches nothing.

Then the port's and JAX's ``Tuner.decide`` over the same seeded sequences
of ``Snapshot``s (each applied as it is decided) give identical decision
lists, step by step; and the three ``test_demote_*`` topology tests hold
the port's ``topology.demote_in_edges``/``promote_rank`` to JAX's, bit for
bit on ``ExponentialTwoGraph(8)``. ``test_tuner.py``'s
``test_healed_tables_*`` drives the window optimizers' healed tables,
which wait for the port's window layer (ROADMAP Queue 1, item 6).
"""

import json

import networkx as nx
import numpy as np
import pytest

from bluefog_tpu import topology_util as jtu
from bluefog_tpu.runtime import tuner as jtuner
from bluefog_tpu_torch import topology as tu
from bluefog_tpu_torch.runtime import metrics as bf_metrics
from bluefog_tpu_torch.runtime import tuner

RULES = dict(tuner.DEFAULT_RULES, slow_for=10.0, straggler_for=10.0,
             dwell=30.0)


@pytest.fixture(autouse=True)
def _fresh_tuner_state():
    tuner.reset_for_job()
    yield
    tuner.reset_for_job()


def _tuner(rank=0, world=4, mod=tuner, **over):
    return mod.Tuner(rank, world, rules=dict(RULES, **over))


def _snap(now, edges=None, stragglers=(), alerts=(), ef_norm=0.0,
          owned=(0,), epoch=0, rank=0, mod=tuner):
    return mod.Snapshot(
        now=now, epoch=epoch, rank=rank, owned=set(owned),
        edges={e: mod.EdgeSample(*v) if isinstance(v, tuple)
               else mod.EdgeSample(bps=v)
               for e, v in (edges or {}).items()},
        stragglers=set(stragglers), alerts=set(alerts), ef_norm=ef_norm)


def _apply(t, snap):
    out = t.decide(snap)
    for d in out:
        t.note_applied(d, snap.now)
    return out


# ---------------------------------------------------------------------------
# rules grammar
# ---------------------------------------------------------------------------

def test_parse_tune_rules_grammar():
    assert tuner.DEFAULT_RULES == jtuner.DEFAULT_RULES
    assert tuner.LADDER == jtuner.LADDER
    for spec in (None, "slow_ratio=0.3, dwell=5",
                 "bogus=1,slow_for=abc,keep_in=2"):
        assert tuner.parse_tune_rules(spec) == jtuner.parse_tune_rules(spec)
    r = tuner.parse_tune_rules("slow_ratio=0.3, dwell=5")
    assert r["slow_ratio"] == 0.3 and r["dwell"] == 5.0
    assert r["slow_for"] == tuner.DEFAULT_RULES["slow_for"]
    # unknown keys and malformed values warn-skip (config never crashes)
    r = tuner.parse_tune_rules("bogus=1,slow_for=abc,keep_in=2")
    assert r["slow_for"] == tuner.DEFAULT_RULES["slow_for"]
    assert r["keep_in"] == 2.0 and "bogus" not in r


# ---------------------------------------------------------------------------
# codec lever: escalation / de-escalation
# ---------------------------------------------------------------------------

def test_slow_edge_escalates_ladder_after_sustained_breach():
    t = _tuner()
    edges = {(0, 1): 10.0, (0, 2): 1000.0, (2, 3): 1100.0}
    assert _apply(t, _snap(0.0, edges)) == []   # the breach clock starts
    assert _apply(t, _snap(5.0, edges)) == []   # not yet slow_for seconds
    out = _apply(t, _snap(11.0, edges))         # ONE rung up
    assert [(d.lever, d.target, d.action, d.arg) for d in out] == \
        [("codec", (0, 1), "escalate", "int8")]
    assert _apply(t, _snap(12.0, edges)) == []  # dwell
    assert _apply(t, _snap(40.0, edges)) == []  # 29 s since the move
    out = _apply(t, _snap(45.0, edges))
    assert [(d.target, d.arg) for d in out] == [((0, 1), "topk:0.01")]
    assert _apply(t, _snap(100.0, edges)) == []  # top of the ladder
    assert _apply(t, _snap(111.0, edges)) == []


def test_breach_clock_resets_when_edge_recovers():
    t = _tuner()
    slow = {(0, 1): 10.0, (0, 2): 1000.0, (2, 3): 1000.0}
    fast = {(0, 1): 900.0, (0, 2): 1000.0, (2, 3): 1000.0}
    _apply(t, _snap(0.0, slow))
    _apply(t, _snap(8.0, fast))    # recovered before slow_for: clock off
    assert _apply(t, _snap(11.0, slow)) == []  # a new clock starts HERE
    assert _apply(t, _snap(20.0, slow)) == []
    out = _apply(t, _snap(22.0, slow))
    assert len(out) == 1 and out[0].target == (0, 1)


def test_only_owned_out_edges_escalate():
    t = _tuner()
    edges = {(3, 1): 10.0, (0, 2): 1000.0, (2, 3): 1100.0}
    _apply(t, _snap(0.0, edges, owned=(0,)))
    # (3,1) is slow but rank 3 is not ours: rank 3's controller owns it
    assert _apply(t, _snap(11.0, edges, owned=(0,))) == []


def test_absolute_floor_and_transit_p99_triggers():
    t = _tuner(min_bps=500.0)
    edges = {(0, 1): 400.0, (0, 2): 600.0, (2, 3): 650.0}
    _apply(t, _snap(0.0, edges))
    out = _apply(t, _snap(11.0, edges))
    assert [d.target for d in out] == [(0, 1)] and "floor" in out[0].reason
    t2 = _tuner(transit_p99_ms=50.0)
    edges = {(0, 1): (1000.0, 80_000.0), (0, 2): (1000.0, 1000.0),
             (2, 3): (1000.0, 900.0)}
    _apply(t2, _snap(0.0, edges))
    out = _apply(t2, _snap(11.0, edges))
    assert [d.target for d in out] == [(0, 1)]
    assert "p99" in out[0].reason


def test_deescalation_on_consensus_stall_and_ef_pressure():
    t = _tuner()
    t._level[(0, 1)] = 2  # already at topk
    t._level[(0, 2)] = 1  # at int8
    out = _apply(t, _snap(0.0, alerts={"consensus_stall"}))
    assert sorted((d.target, d.arg) for d in out
                  if d.action == "deescalate") == \
        [((0, 1), "int8"), ((0, 2), None)]
    assert t._level == {(0, 1): 1}  # the int8 edge fell off the ladder
    t2 = _tuner(deesc_norm=5.0)
    t2._level[(0, 1)] = 1
    out = _apply(t2, _snap(0.0, ef_norm=9.0))
    assert [(d.target, d.action) for d in out] == [((0, 1), "deescalate")]
    assert t2._level == {}
    t2._level[(0, 1)] = 1
    assert _apply(t2, _snap(100.0, ef_norm=1.0)) == []


# ---------------------------------------------------------------------------
# in-degree lever: demote / promote
# ---------------------------------------------------------------------------

def test_straggler_demotes_then_promotes_on_recovery():
    t = _tuner()
    _apply(t, _snap(0.0, stragglers={3}))
    assert t._demoted == {}
    out = _apply(t, _snap(11.0, stragglers={3}))
    assert [(d.lever, d.target, d.action) for d in out] == \
        [("indegree", 3, "demote")]
    assert 3 in t._demoted
    assert _apply(t, _snap(12.0, stragglers={3})) == []  # already demoted
    # recovery must be SUSTAINED too, and the promote respects dwell
    assert _apply(t, _snap(45.0, stragglers=set())) == []
    out = _apply(t, _snap(56.0, stragglers=set()))
    assert [(d.target, d.action) for d in out] == [(3, "promote")]
    assert t._demoted == {}


def test_straggler_relapse_resets_recovery_clock():
    t = _tuner()
    t._demoted[3] = frozenset({(1, 3)})
    t._last_act[("indegree", 3)] = -100.0
    _apply(t, _snap(0.0, stragglers=set()))   # the recovery clock starts
    _apply(t, _snap(5.0, stragglers={3}))     # relapse: the clock resets
    assert _apply(t, _snap(12.0, stragglers=set())) == []
    out = _apply(t, _snap(23.0, stragglers=set()))
    assert [(d.target, d.action) for d in out] == [(3, "promote")]


def test_demote_targets_keep_fastest_in_edges(monkeypatch):
    from bluefog_tpu_torch.runtime.state import _global_state

    class _W:
        in_neighbors = {3: [0, 1, 2]}

    monkeypatch.setattr(_global_state(), "windows", {"w": _W()})
    snap = _snap(0.0, {(0, 3): 50.0, (1, 3): 900.0, (2, 3): 200.0})
    # keeps the fastest in-edge (1->3); drops the rest
    assert sorted(_tuner(keep_in=1)._demote_targets(snap, 3)) == \
        [(0, 3), (2, 3)]
    assert sorted(_tuner(keep_in=2)._demote_targets(snap, 3)) == [(0, 3)]
    # no window (every port job until item 6): nothing to demote
    monkeypatch.setattr(_global_state(), "windows", {})
    assert _tuner()._demote_targets(snap, 3) == []


# ---------------------------------------------------------------------------
# the tick: epoch fence, single-controller application, off path
# ---------------------------------------------------------------------------

def test_epoch_fence_defers_decision_racing_rejoin(monkeypatch):
    """A membership-epoch bump between the sensor snapshot and the
    actuation defers the decision; the next tick re-decides."""
    import bluefog_tpu_torch.runtime.heartbeat as hb

    monkeypatch.setenv("BFT_TUNE", "1")
    t = _tuner()
    t._breach[("straggler", 3)] = -100.0  # sustained long ago
    snap = _snap(0.0, stragglers={3}, epoch=5)
    monkeypatch.setattr(t, "gather", lambda cl=None, now=None: snap)
    monkeypatch.setattr(hb, "membership_epoch", lambda: 6)  # mid-decision
    deferred0 = bf_metrics.counter("tune.deferred").value
    assert t.tick(cl=None, now=0.0) == []
    assert bf_metrics.counter("tune.deferred").value == deferred0 + 1
    assert t._demoted == {}                    # state untouched
    assert ("indegree", 3) not in t._last_act  # dwell NOT burned
    assert t._decisions[-1]["status"] == "deferred"


def test_single_controller_demotion_applies_through_tick(monkeypatch):
    import bluefog_tpu_torch.runtime.heartbeat as hb

    monkeypatch.setenv("BFT_TUNE", "1")
    t = _tuner(rank=0, world=4)
    t._breach[("straggler", 3)] = -100.0
    snap = _snap(0.0, stragglers={3}, epoch=0)
    monkeypatch.setattr(t, "gather", lambda cl=None, now=None: snap)
    monkeypatch.setattr(hb, "membership_epoch", lambda: 0)
    monkeypatch.setattr(hb, "dead_controllers", lambda: set())
    monkeypatch.setattr(t, "_demote_targets",
                        lambda s, p: [(0, 3), (2, 3)])
    applied = t.tick(cl=None, now=0.0)
    assert [(d.lever, d.action) for d in applied] == [("indegree",
                                                       "demote")]
    # the optimizers' accessor sees it at once (no KV, no epoch wait)
    assert tuner.demoted_edges() == frozenset({(0, 3), (2, 3)})
    snap2 = _snap(45.0, stragglers=set(), epoch=0)
    monkeypatch.setattr(t, "gather", lambda cl=None, now=None: snap2)
    assert t.tick(cl=None, now=45.0) == []  # the recovery clock starts
    snap3 = _snap(56.0, stragglers=set(), epoch=0)
    monkeypatch.setattr(t, "gather", lambda cl=None, now=None: snap3)
    applied = t.tick(cl=None, now=56.0)
    assert [d.action for d in applied] == ["promote"]
    assert tuner.demoted_edges() == frozenset()


def test_tune_off_touches_nothing(monkeypatch):
    """``BFT_TUNE=0`` (the default): ``demoted_edges()`` is empty with no
    control-plane traffic and ``maybe_tick`` never builds the singleton."""
    import bluefog_tpu_torch.runtime.control_plane as cp

    monkeypatch.delenv("BFT_TUNE", raising=False)

    def _boom(*a, **k):  # any control-plane touch is a failure
        raise AssertionError("tuner touched the control plane while off")

    monkeypatch.setattr(cp, "active", _boom)
    monkeypatch.setattr(cp, "client", _boom)
    assert tuner.enabled() is False
    assert tuner.demoted_edges() == frozenset()
    tuner.maybe_tick(cl=None)
    assert tuner._singleton is None  # never even constructed


def test_maybe_tick_interval_gated(monkeypatch):
    monkeypatch.setenv("BFT_TUNE", "1")
    monkeypatch.setenv("BFT_TUNE_INTERVAL", "100")
    t = _tuner()
    calls = []
    monkeypatch.setattr(t, "tick",
                        lambda cl=None, now=None: calls.append(now))
    t.maybe_tick(cl=None, now=1000.0)
    assert calls == [1000.0]
    t._last_tick = 1000.0
    t.maybe_tick(cl=None, now=1050.0)   # inside the interval: gated
    assert calls == [1000.0]
    t.maybe_tick(cl=None, now=1101.0)
    assert calls == [1000.0, 1101.0]


def test_decision_trail_document_shape(monkeypatch):
    """The ``bf.tune.<rank>`` document, the same bytes from both
    packages: codec levels in the ``s>d`` grammar, the demoted map, the
    bounded decision ring."""
    monkeypatch.setenv("BFT_TUNE", "1")
    wrote = {}

    class _Cl:
        def __init__(self, pkg):
            self.pkg = pkg

        def put_bytes(self, key, blob):
            wrote[(self.pkg, key)] = blob

    for pkg, mod in (("port", tuner), ("jax", jtuner)):
        t = _tuner(mod=mod)
        t._level[(0, 1)] = 1
        t._demoted[3] = frozenset({(0, 3)})
        t._record(mod.Decision("codec", (0, 1), "escalate", "int8", "slow"),
                  1.0, "applied")
        t._publish_trail(_Cl(pkg), now=2.0)
    assert wrote[("port", "bf.tune.0")] == wrote[("jax", "bf.tune.0")]
    doc = json.loads(wrote[("port", "bf.tune.0")].decode())
    assert doc["levels"] == {"0>1": "int8"}
    assert doc["demoted"] == {"3": [[0, 3]]}
    assert doc["decisions"][-1]["action"] == "escalate"
    assert doc["decisions"][-1]["target"] == [0, 1]


# ---------------------------------------------------------------------------
# the decision table against JAX's on seeded snapshots
# ---------------------------------------------------------------------------

def _seeded_snapshots(seed: int, steps: int = 80):
    """A random walk over a 6-rank world: per-edge bps (some edges slow
    for stretches, some with p99 transit), stragglers that come and go,
    stall alerts and EF-residual spikes, at uneven times."""
    rng = np.random.default_rng(seed)
    edges = [(s, d) for s in range(6) for d in range(6)
             if s != d and rng.random() < 0.4]
    slow = set()
    stragglers = set()
    now = 0.0
    out = []
    for _ in range(steps):
        now += float(rng.uniform(0.5, 6.0))
        for e in edges:
            if rng.random() < 0.08:
                slow ^= {e}
        for p in range(6):
            if rng.random() < 0.05:
                stragglers ^= {p}
        sample = {}
        for e in edges:
            bps = float(rng.uniform(800.0, 1200.0))
            if e in slow:
                bps *= float(rng.uniform(0.01, 0.3))
            if rng.random() < 0.1:
                bps = 0.0  # no data this tick
            p99 = float(rng.uniform(1e3, 9e4)) if rng.random() < 0.3 \
                else None
            sample[e] = (bps, p99)
        alerts = {"consensus_stall"} if rng.random() < 0.07 else set()
        ef = float(rng.uniform(0.0, 12.0))
        out.append(dict(now=now, edges=sample, stragglers=set(stragglers),
                        alerts=alerts, ef_norm=ef, owned=(0, 1, 2)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decide_matches_jax_on_seeded_snapshots(seed):
    rules = dict(tuner.DEFAULT_RULES, slow_for=8.0, straggler_for=6.0,
                 dwell=12.0, min_bps=150.0, transit_p99_ms=70.0,
                 deesc_norm=10.0)
    port = tuner.Tuner(0, 6, rules=rules)
    jax_ = jtuner.Tuner(0, 6, rules=rules)
    moves = 0
    for kw in _seeded_snapshots(seed):
        trails = []
        for t, mod in ((port, tuner), (jax_, jtuner)):
            out = _apply(t, _snap(mod=mod, **kw))
            trails.append([(d.lever, d.target, d.action, d.arg, d.reason)
                           for d in out])
        assert trails[0] == trails[1], kw["now"]
        moves += len(trails[0])
        assert port._level == jax_._level
        assert port._demoted == jax_._demoted
        assert port._breach == jax_._breach
    assert moves >= 5  # the walk exercised the table


# ---------------------------------------------------------------------------
# topology: demote -> promote restores W exactly, as in JAX
# ---------------------------------------------------------------------------

def _w(G):
    return nx.to_numpy_array(G)


def test_demote_preserves_column_sums_and_composes():
    G, JG = tu.ExponentialTwoGraph(8), jtu.ExponentialTwoGraph(8)
    W0 = _w(G)
    np.testing.assert_array_equal(W0, _w(JG))
    Gd, JGd = tu.demote_in_edges(G, 3, {1, 2}), jtu.demote_in_edges(
        JG, 3, {1, 2})
    Wd = _w(Gd)
    np.testing.assert_array_equal(Wd, _w(JGd))
    # only column 3 changed; its sum is preserved
    np.testing.assert_array_equal(np.delete(Wd, 3, axis=1),
                                  np.delete(W0, 3, axis=1))
    assert Wd[:, 3].sum() == pytest.approx(W0[:, 3].sum(), abs=1e-12)
    assert Wd[1, 3] == 0.0 and Wd[2, 3] == 0.0
    assert Wd[3, 3] > W0[3, 3]  # renormalized onto the survivors
    # composes: a second rank's demotion re-derives from the ORIGINAL
    Wdd = _w(tu.demote_in_edges(Gd, 5, {4}))
    np.testing.assert_array_equal(Wdd, _w(jtu.demote_in_edges(JGd, 5, {4})))
    np.testing.assert_array_equal(Wdd[:, 3], Wd[:, 3])
    assert Wdd[:, 5].sum() == pytest.approx(W0[:, 5].sum(), abs=1e-12)


def test_demote_promote_roundtrip_restores_w_exactly():
    G, JG = tu.ExponentialTwoGraph(8), jtu.ExponentialTwoGraph(8)
    W0 = _w(G)
    Gd, JGd = tu.demote_in_edges(G, 3, {1, 2}), jtu.demote_in_edges(
        JG, 3, {1, 2})
    Gp, JGp = tu.promote_rank(Gd, 3), jtu.promote_rank(JGd, 3)
    np.testing.assert_array_equal(_w(Gp), W0)
    np.testing.assert_array_equal(_w(Gp), _w(JGp))
    assert "_bf_demote" not in Gp.graph or \
        not Gp.graph["_bf_demote"]["demoted"]
    # partial promotion: rank 5's demotion survives rank 3's recovery
    Gp2 = tu.promote_rank(tu.demote_in_edges(Gd, 5, {4}), 3)
    JGp2 = jtu.promote_rank(jtu.demote_in_edges(JGd, 5, {4}), 3)
    W2 = _w(Gp2)
    np.testing.assert_array_equal(W2, _w(JGp2))
    np.testing.assert_array_equal(W2[:, 3], W0[:, 3])
    assert W2[4, 5] == 0.0
    assert tu.promote_rank(G, 2) is G  # a never-demoted rank: identity


def test_demote_never_drops_self_loop_and_guards_empty_column():
    G, JG = tu.RingGraph(4, connect_style=1), jtu.RingGraph(
        4, connect_style=1)
    Wd = _w(tu.demote_in_edges(G, 1, {2, 1}))  # self in the set: ignored
    np.testing.assert_array_equal(Wd, _w(jtu.demote_in_edges(JG, 1, {2, 1})))
    assert Wd[1, 1] == pytest.approx(_w(G)[:, 1].sum())
    # dropping EVERY in-edge of a rank with no self-weight raises
    W = np.array([[0.0, 1.0], [1.0, 0.0]])
    for mod in (tu, jtu):
        G2 = nx.from_numpy_array(W, create_using=nx.DiGraph)
        with pytest.raises(ValueError, match="renormalize"):
            mod.demote_in_edges(G2, 1, {0})
