"""Port vs JAX: the window ops on the collective plane at world 4.

Four gloo processes (``tests/_torch_port_child.py`` mode ``win_ops``, no
control plane, ``BFT_WIN_PLANE=compiled``) each pass their own rank's
tensor through the scenarios of ``tests/_torch_port_win_child.py``, the
counterparts of ``tests/test_win_ops.py``: create/update, put then update,
zero-init, a dynamic partial-destination put (only the right neighbour
written; the other slot's write lands in the scratch slot), clone,
update-then-collect twice, stacked accumulates, self-weight scaling, get
with and without source weights, versions after 0/1/2 puts and an update,
8 rounds of push-sum with associated p, an integer window with fractional
weights, bf16, and the nonblocking forms through poll/wait with a fence.
Each runs on ``RingGraph(4)`` and ``ExponentialTwoGraph(4)``. The JAX
package runs the same scenarios on 4 CPU devices; every rank's result must
equal JAX's row for that rank.

Tolerances: f32 to 1e-6 (absolute and relative: the same weighted sums in
another order); bf16 to one bf16 ulp of the largest value (both accumulate
in f32 and round once); the integer window, the versions and p exactly.

The same run checks the lifecycle flags against JAX's, the collective
plane's int8 blend against JAX's to 1e-6, and the choices the port makes
without a control plane: a process-local scalar host, every rank's p by
all-gather, ``require_mutex``/``win_mutex`` raising and naming the control
plane (``win_update_then_collect``'s default ``require_mutex=True`` too),
another rank's versions refused.

In process: the plane a window takes, ``_plane_policy`` and
``_hosted_mode_enabled`` against JAX's for every ``BFT_WIN_PLANE`` value,
with and without a control plane of one or four controllers.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import bluefog_tpu as jbf
from bluefog_tpu import topology_util
from bluefog_tpu.ops import windows as JW
from bluefog_tpu_torch.ops import windows as W
from conftest import cpu_devices
from _torch_port_child import run_world
from _torch_port_win_child import lifecycle, run_scenarios

N = 4
TOL = 1e-6
TOPOS = ("ring", "expo2")
SCENARIOS = ("initial", "put_update", "zero_init", "partial_put", "clone_1",
             "clone_2", "collect_1", "collect_2", "accumulate",
             "self_weight_scaling", "get", "get_weights", "versions",
             "pushsum", "pushsum_p", "int_window", "bf16", "nonblocking")
EXACT = ("versions", "pushsum_p", "int_window")


def inputs() -> dict:
    rng = np.random.default_rng(13)
    return {"x": rng.standard_normal((N, 5)).astype(np.float32),
            "ring_x": (np.arange(N, dtype=np.float32) + 1.0).reshape(N, 1)}


class JaxApi:
    """The JAX package's rank-stacked side of the shared scenarios."""

    bf = jbf
    n = N

    @staticmethod
    def mk(a, dtype=None):
        return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else None)

    @staticmethod
    def out(t):
        return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16
                          else t)

    @staticmethod
    def versions(name):
        return np.stack([np.array([v for _, v in sorted(
            jbf.get_win_version(name, rank=r).items())], np.int64)
            for r in range(N)])

    @staticmethod
    def p(name):
        return np.asarray(jbf.win_associated_p_all(name))

    @staticmethod
    def sync():
        pass


def jax_results(inp, monkeypatch=None) -> dict:
    """Every scenario on both topologies, plus lifecycle and the int8
    blend, on JAX's CPU mesh of 4."""
    import os

    out = {}
    jbf.init(devices=cpu_devices(N))
    try:
        for topo in TOPOS:
            jbf.set_topology(topology_util.RingGraph(N) if topo == "ring"
                             else topology_util.ExponentialTwoGraph(N))
            out.update(run_scenarios(JaxApi, inp, topo))
        out.update(lifecycle(jbf, jnp.asarray, inp["x"]))
        x = jnp.asarray(inp["x"])
        jbf.win_create(x, "np")
        jbf.turn_on_win_ops_with_associated_p()
        jbf.win_accumulate(x, "np", self_weight=0.25)
        out["p_all"] = np.asarray(jbf.win_associated_p_all("np"))
        jbf.turn_off_win_ops_with_associated_p()
        jbf.win_free("np")
        os.environ["BLUEFOG_WIN_CODEC"] = "int8"
        try:
            jbf.win_create(x, "q8", zero_init=True)
        finally:
            del os.environ["BLUEFOG_WIN_CODEC"]
        jbf.win_put(x, "q8")
        out["int8_blend"] = np.asarray(jbf.win_update("q8"))
        jbf.win_free("q8")
    finally:
        jbf.shutdown()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("win_ops")
    inp = inputs()
    np.savez(tmp / "inputs.npz", **inp)
    mp = pytest.MonkeyPatch()
    mp.setenv("BFT_WIN_PLANE", "compiled")
    mp.setenv("BFT_CP_DISABLE", "1")
    try:
        port = run_world("win_ops", str(tmp), N, timeout=240)
    finally:
        mp.undo()
    return jax_results(inp), port


def assert_rank_close(got, want, key: str) -> None:
    if key.endswith(EXACT):
        np.testing.assert_array_equal(got, want, err_msg=key)
    elif key.endswith("bf16"):
        ulp = float(np.abs(want).max()) * 2.0 ** -7
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp, err_msg=key)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=key)


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_collective_plane_matches_jax(runs, topo, scenario):
    jx, port = runs
    key = f"{topo}.{scenario}"
    for r in range(N):
        assert_rank_close(port[r][key], jx[key][r], key)


def test_collective_plane_closed_forms(runs):
    """The closed forms of ``tests/test_win_ops.py`` hold on the port's
    own results (rank r's row): zero-init is r/3 of the ring's self term,
    clone twice is idempotent, a second collect returns the first, the
    self-weight scaling restores 1, push-sum's p sums to 4."""
    jx, port = runs
    x = inputs()["x"]
    for r in range(N):
        out = port[r]
        np.testing.assert_allclose(out["ring.zero_init"], x[r] / 3.0,
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(out["ring.clone_1"],
                                      out["ring.clone_2"])
        np.testing.assert_allclose(out["ring.collect_2"],
                                   out["ring.collect_1"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out["expo2.self_weight_scaling"], 1.0,
                                   atol=TOL)
    assert abs(sum(float(port[r]["expo2.pushsum_p"]) for r in range(N))
               - N) < 1e-9


def test_lifecycle_matches_jax(runs):
    jx, port = runs
    want = [True, False, True, False, True, True, False, True, True]
    assert jx["lifecycle"].tolist() == want
    for r in range(N):
        assert port[r]["lifecycle"].tolist() == want


def test_int8_blend_matches_jax(runs):
    jx, port = runs
    for r in range(N):
        np.testing.assert_allclose(port[r]["int8_blend"], jx["int8_blend"][r],
                                   rtol=TOL, atol=TOL)


def test_no_control_plane_choices(runs):
    """Without a control plane: collective plane, process-local host, p of
    every rank by all-gather (equal to JAX's), no mutex, no other rank's
    versions."""
    jx, port = runs
    for r in range(N):
        assert port[r]["no_cp_checks"].all(), port[r]["no_cp_checks"]
        np.testing.assert_array_equal(port[r]["p_all"], jx["p_all"])


PLANE_VALUES = (None, "auto", "AUTO", "compiled", "hosted", "bogus", "")


def _set_plane(mp, raw) -> None:
    for k in ("BFT_WIN_PLANE", "BLUEFOG_WIN_PLANE", "BLUEFOG_WIN_HOST_PLANE"):
        mp.delenv(k, raising=False)
    if raw is not None:
        mp.setenv("BFT_WIN_PLANE", raw)
        mp.setenv("BLUEFOG_WIN_PLANE", raw)


@pytest.mark.parametrize("raw", PLANE_VALUES)
def test_plane_policy_matches_jax(monkeypatch, raw):
    _set_plane(monkeypatch, raw)
    assert W._plane_policy() == JW._plane_policy()


@pytest.mark.parametrize("active,world", [(False, 4), (True, 1), (True, 4)])
def test_hosted_mode_matches_jax(monkeypatch, active, world):
    """A new window is hosted iff a control plane is attached and, under
    ``auto``, spans more than one controller; the knob forces either way
    only with a control plane. In the port each rank is its own
    controller, so under ``auto`` this is every edge's plane."""
    for cp in (W._cp, JW._cp):
        monkeypatch.setattr(cp, "active", lambda: active)
        monkeypatch.setattr(cp, "world", lambda: world)
    verdicts = []
    for raw in PLANE_VALUES:
        _set_plane(monkeypatch, raw)
        verdicts.append(W._hosted_mode_enabled())
        assert verdicts[-1] == JW._hosted_mode_enabled(), raw
    if not active:
        assert not any(verdicts)
    else:
        assert verdicts[3:5] == [False, True]
        assert verdicts[0] == (world > 1)
