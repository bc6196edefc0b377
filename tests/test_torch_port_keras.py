"""Port vs JAX: the Keras frontend.

``bluefog_tpu_torch.keras`` on ``KERAS_BACKEND=torch`` against
``bluefog_tpu.keras`` on ``KERAS_BACKEND=jax``. Keras fixes its backend at
import, so each side runs in processes of its own
(``tests/_torch_port_keras_child.py``): JAX's in one process over 4 forced
CPU devices, the port's as a world-4 gloo job whose ranks block ``jax``,
``jaxlib``, ``flax`` and ``optax`` before importing anything. Both start
from the same numpy weights (``set_weights``) and take the same seeded
numpy gradients (Keras draws its init differently per backend, so no init
is compared), and every rank's weights after each scenario agree within
1e-6. Then the port's ``keras_mnist`` example under ``bfrun --simulate 4``.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

if importlib.util.find_spec("keras") is None:  # pragma: no cover
    pytest.skip("keras is not installed", allow_module_level=True)

TESTS = Path(__file__).resolve().parent
CHILD = str(TESTS / "_torch_port_keras_child.py")
N = 4
TOL = 1e-6
TIMEOUT = 300


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BFT_", "KERAS_", "MASTER_"))
           and k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK",
                         "LOCAL_WORLD_SIZE", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.pathsep.join([str(TESTS.parent),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env["TF_CPP_MIN_LOG_LEVEL"] = "3"
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides at once: JAX's process and the port's four ranks."""
    d = tmp_path_factory.mktemp("torch_port_keras")
    rng = np.random.RandomState(0)
    steps = 3
    np.savez(d / "inputs.npz",
             k=rng.randn(N, 4, 2).astype(np.float32),
             b=rng.randn(N, 2).astype(np.float32),
             gk=rng.randn(steps, N, 4, 2).astype(np.float32),
             gb=rng.randn(steps, N, 2).astype(np.float32))
    env = _env()
    env["BLUEFOG_FLIGHT_DIR"] = env["BFT_FLIGHT_DIR"] = str(d)
    cmds = [[sys.executable, CHILD, "jax", str(d)]] + [
        [sys.executable, CHILD, "port", str(r), str(N), str(d)]
        for r in range(N)]
    procs = [subprocess.Popen(c, env=env, cwd=d, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, log in zip(cmds, procs, logs):
        assert p.returncode == 0, f"{c[2:]} ended with {p.returncode}:\n{log}"
    jax_w = dict(np.load(d / "jax.npz"))
    port_w = {k: np.stack([np.load(d / f"out_{r}.npz")[k]
                           for r in range(N)]) for k in jax_w}
    msgs = json.loads((d / "jax.json").read_text())
    port_msgs = [json.loads((d / f"out_{r}.json").read_text())
                 for r in range(N)]
    return {"inp": dict(np.load(d / "inputs.npz")), "jax": jax_w,
            "port": port_w, "msgs": msgs, "port_msgs": port_msgs}


def _close(runs, name):
    for leaf in ("k", "b"):
        got, want = runs["port"][f"{name}_{leaf}"], runs["jax"][f"{name}_{leaf}"]
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_port_ranks_ran_without_jax(runs):
    for m in runs["port_msgs"]:
        assert m["loaded"] == []


def test_broadcast_variables_from_root_three(runs):
    _close(runs, "bcast")
    inp = runs["inp"]
    for r in range(N):
        np.testing.assert_array_equal(runs["port"]["bcast_k"][r],
                                      inp["k"][3])
        np.testing.assert_array_equal(runs["port"]["bcast_b"][r],
                                      inp["b"][3])


def test_allreduce_mode_matches_mean_gradient_step(runs):
    """Every replica took the same step, with the rank-mean gradient."""
    _close(runs, "allreduce")
    inp = runs["inp"]
    for leaf in ("k", "b"):
        want = inp[leaf][0] - 0.5 * inp[f"g{leaf}"][0].mean(axis=0)
        for r in range(N):
            np.testing.assert_allclose(runs["port"][f"allreduce_{leaf}"][r],
                                       want, rtol=0, atol=1e-5)


def test_neighbor_mode_matches_jax_and_moves_to_consensus(runs):
    """Three steps of SGD then the Expo-2 mix: JAX's weights at every step,
    and the ranks' spread shrinks from the start's."""
    for step in (1, 2, 3):
        _close(runs, f"neighbor{step}")
    start = runs["inp"]["k"]
    end = runs["port"]["neighbor3_k"]

    def spread(w):
        return np.abs(w - w.mean(axis=0, keepdims=True)).max()

    assert spread(end) < 0.5 * spread(start)


def test_every_second_step_communicates(runs):
    """``num_steps_per_communication=2``: steps 1 and 3 stay local (each
    rank its own gradient), step 2 applies the mean gradient."""
    for step in (1, 2, 3):
        _close(runs, f"every2_{step}")
    inp = runs["inp"]
    for leaf in ("k", "b"):
        w, g = inp[leaf], inp[f"g{leaf}"]
        one = w - 0.5 * g[0]
        two = one - 0.5 * g[1].mean(axis=0)
        three = two - 0.5 * g[2]
        for step, want in ((1, one), (2, two), (3, three)):
            np.testing.assert_allclose(
                runs["port"][f"every2_{step}_{leaf}"], want, rtol=0,
                atol=1e-5)


def test_refusals_and_passthrough_match_jax(runs):
    """The same messages as JAX's, every rank; the owned-replica count is
    each controller's own (JAX's holds 4 ranks, a port process 1)."""
    jax_msgs = runs["msgs"]
    for m in runs["port_msgs"]:
        for key in ("communication_type", "factory", "optimizer_list",
                    "gradient_lists", "apply_gradients", "learning_rate"):
            assert m[key] == jax_msgs[key], key
        assert m["replicas"] == ("ValueError: need one model replica per "
                                 "rank this controller owns (1), got 2")
    assert jax_msgs["replicas"] == ("ValueError: need one model replica per "
                                    "rank this controller owns (4), got 5")
    assert re.match(r"ValueError: unknown communication_type 'bogus'",
                    jax_msgs["communication_type"])
    assert "factory" in jax_msgs["factory"]
    assert jax_msgs["apply_gradients"].startswith("RuntimeError")
    assert jax_msgs["learning_rate"] == "0.5"


def test_keras_mnist_example_under_bfrun_simulate(tmp_path):
    env = _env()
    env["BFT_FLIGHT_DIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.launcher", "--simulate",
         str(N), "--", sys.executable, "-m",
         "bluefog_tpu_torch.examples.keras_mnist"],
        env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"ranks: {N} (keras frontend)" in out.stdout
    assert "KERAS TRAIN OK" in out.stdout
