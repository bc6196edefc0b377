"""Port vs JAX: the torch frontend (``bluefog_tpu_torch/torch_frontend.py``
against ``bluefog_tpu/torch/__init__.py``).

The port's frontend runs at world 4 in gloo children (one rank each,
``tests/_torch_port_frontend_child.py``); JAX's runs on its CPU mesh of 4
over the same seeded numpy inputs, all four ranks' modules in one process
(``device_resident=False``, since the port has no dlpack residency). The
cases are those of ``tests/test_torch_frontend.py``: each op once,
``DistributedTorchOptimizer`` mixing the parameters under SGD and Adam and
with ``num_steps_per_communication=2``, the dynamic neighbour allreduce,
``broadcast_parameters``, ``broadcast_optimizer_state`` and Adam's step
counter not aliased. Parameters and results agree to 1e-6 in f32 (the
same sums in another order).

The small flash ``TransformerLM`` (the plain K1-K3 on the CPU) trained in
a user's loop under ``DistributedTorchOptimizer`` equals
``DistributedNeighborAllreduceOptimizer.step(batch)`` bit for bit at world
1, where the combine multiplies by 1.0 in f32, and to 1e-6 at world 4.
The ported example prints ``TORCH CONSENSUS OK`` under the port's
``--simulate 4``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu.torch as jbft
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import torch_frontend
from conftest import cpu_devices
from _torch_port_child import run_world
from _torch_port_frontend_child import linear, lm_runs

N = 4
TOL = 1e-6
LM_STEPS = 3


def _inputs() -> dict:
    rng = np.random.default_rng(16)
    return {"w": rng.standard_normal((N, 2, 4)).astype(np.float32),
            "b": rng.standard_normal((N, 2)).astype(np.float32),
            "x": rng.standard_normal((N, 16, 4)).astype(np.float32),
            "v": rng.standard_normal((N, 3)).astype(np.float32),
            "tokens": rng.integers(0, 64, (N, 1, 16)),
            "targets": rng.integers(0, 64, (N, 1, 16)),
            "lm_steps": LM_STEPS}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("frontend")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    return inp, run_world("frontend", str(d), N, timeout=240)


def _weights(m) -> np.ndarray:
    return np.concatenate([m.weight.detach().numpy().ravel(),
                           m.bias.detach().numpy().ravel()])


def _jax_train(inp, make_opt, steps: int, every: int = 1) -> np.ndarray:
    mods = [linear(torch, inp, r) for r in range(N)]
    params = [p for m in mods for p in m.parameters()]
    opt = jbft.DistributedTorchOptimizer(
        make_opt(params), mods, num_steps_per_communication=every,
        device_resident=False)
    xs = [torch.from_numpy(inp["x"][r]) for r in range(N)]
    trail = []
    for _ in range(steps):
        opt.zero_grad()
        sum(m(x).square().mean() for m, x in zip(mods, xs)).backward()
        opt.step()
        trail.append(np.stack([_weights(m) for m in mods]))
    return np.stack(trail, axis=1)          # [rank, step, 10]


@pytest.fixture(scope="module")
def jax_run(port):
    inp = port[0]
    bf.init(devices=cpu_devices(N))
    try:
        v = torch.from_numpy(inp["v"])
        out = {"allreduce": jbft.allreduce(v),
               "neighbor_allreduce": jbft.neighbor_allreduce(v),
               "broadcast": jbft.broadcast(v, root_rank=2),
               "allgather": jbft.allgather(v),
               "neighbor_allgather": jbft.neighbor_allgather(v),
               "dynamic": jbft.neighbor_allreduce(
                   v, self_weight=0.5,
                   neighbor_weights={r: {(r - 1) % N: 0.5}
                                     for r in range(N)},
                   send_neighbors={r: [(r + 1) % N] for r in range(N)})}
        assert jbft.win_create(v, "f.win", zero_init=True)
        jbft.win_put(v, "f.win")
        out["win_update"] = jbft.win_update("f.win")
        jbft.win_free("f.win")
        out = {k: t.numpy() for k, t in out.items()}
        out["sgd"] = _jax_train(inp, lambda ps: torch.optim.SGD(
            ps, lr=0.05), 6)
        out["adam"] = _jax_train(inp, lambda ps: torch.optim.Adam(
            ps, lr=0.01), 6)
        out["every2"] = _jax_train(inp, lambda ps: torch.optim.SGD(
            ps, lr=0.05), 4, every=2)
        mods = [linear(torch, inp, r) for r in range(N)]
        jbft.broadcast_parameters(mods, root_rank=2)
        out["bcast_params"] = np.stack([_weights(m) for m in mods])
        mods = [linear(torch, inp, r) for r in range(N)]
        opt = torch.optim.SGD([p for m in mods for p in m.parameters()],
                              lr=0.1, momentum=0.9)
        for r, m in enumerate(mods):
            (m(torch.full((4, 4), float(r + 1))) ** 2).mean().backward()
        opt.step()
        jbft.broadcast_optimizer_state(opt, mods, root_rank=1)
        out["momentum_after"] = np.stack(
            [opt.state[m.weight]["momentum_buffer"].numpy() for m in mods])
    finally:
        bf.shutdown()
    return out


def test_ops_are_the_ports_own_and_all_is_jaxs_less_the_absent():
    for name in ("allreduce", "neighbor_allreduce", "broadcast",
                 "allgather", "neighbor_allgather", "win_create", "win_put",
                 "win_get", "win_accumulate", "win_update",
                 "win_update_then_collect", "win_free"):
        assert getattr(torch_frontend, name) is getattr(bft, name), name
    from bluefog_tpu_torch.runtime import control_plane

    assert torch_frontend.owned_ranks is control_plane.owned_ranks
    absent = {"to_jax", "to_torch"}
    assert set(torch_frontend.__all__) == set(jbft.__all__) - absent
    assert len(torch_frontend.__all__) == len(set(torch_frontend.__all__))


@pytest.mark.parametrize("op", ["allreduce", "neighbor_allreduce",
                                "broadcast", "allgather",
                                "neighbor_allgather", "win_update"])
def test_op_against_jax_frontend(port, jax_run, op):
    outs = port[1]
    for r in range(N):
        np.testing.assert_allclose(outs[r][op], jax_run[op][r], rtol=0,
                                   atol=TOL)
        assert outs[r]["owned_ranks"].tolist() == [r]


def test_dynamic_neighbor_allreduce_torch(port, jax_run):
    outs, v = port[1], port[0]["v"]
    for r in range(N):
        np.testing.assert_allclose(outs[r]["dynamic"], jax_run["dynamic"][r],
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(outs[r]["dynamic"],
                                   0.5 * v[r] + 0.5 * v[(r - 1) % N],
                                   atol=TOL)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_distributed_torch_optimizer_mixes_params(port, jax_run, kind):
    """Each rank's weights after every step of the user's loop equal JAX's
    rank row; the ranks move towards their mean."""
    outs = port[1]
    for r in range(N):
        np.testing.assert_allclose(outs[r][kind], jax_run[kind][r], rtol=0,
                                   atol=TOL)
    w = np.stack([outs[r][kind] for r in range(N)])      # [rank, step, 10]
    spread = np.abs(w - w.mean(axis=0)).max(axis=(0, 2))
    assert spread[-1] < spread[0]


def test_optimizer_num_steps_per_communication(port, jax_run):
    """At N = 2 the odd steps are local only: equal to JAX's, and a rank's
    weights after step 1 are its plain SGD step."""
    outs, inp = port[1], port[0]
    for r in range(N):
        np.testing.assert_allclose(outs[r]["every2"], jax_run["every2"][r],
                                   rtol=0, atol=TOL)
        m = linear(torch, inp, r)
        opt = torch.optim.SGD(m.parameters(), lr=0.05)
        m(torch.from_numpy(inp["x"][r])).square().mean().backward()
        opt.step()
        np.testing.assert_array_equal(outs[r]["every2"][0], _weights(m))


def test_broadcast_parameters(port, jax_run):
    outs = port[1]
    for r in range(N):
        np.testing.assert_allclose(outs[r]["bcast_params"],
                                   jax_run["bcast_params"][r], rtol=0,
                                   atol=TOL)
        np.testing.assert_array_equal(outs[r]["bcast_params"],
                                      outs[2]["bcast_params"])


def test_broadcast_optimizer_state(port, jax_run):
    """Divergent momenta are replaced by rank 1's, as in JAX."""
    outs = port[1]
    assert not np.allclose(outs[0]["momentum_before"],
                           outs[3]["momentum_before"])
    for r in range(N):
        np.testing.assert_allclose(outs[r]["momentum_after"],
                                   jax_run["momentum_after"][r], rtol=0,
                                   atol=TOL)
        np.testing.assert_array_equal(outs[r]["momentum_after"],
                                      outs[1]["momentum_before"])


def test_broadcast_optimizer_state_adam_step_not_aliased(port):
    for r in range(N):
        assert int(port[1][r]["adam_steps_distinct"]) == 2
        assert port[1][r]["adam_steps"].tolist() == [3.0, 3.0]


def test_user_loop_lm_against_fused_step_world_4(port):
    outs = port[1]
    for r in range(N):
        o = outs[r]
        np.testing.assert_allclose(o["user_losses"], o["fused_losses"],
                                   rtol=0, atol=TOL)
        names = [k[len("user:"):] for k in o if k.startswith("user:")]
        assert names
        for k in names:
            np.testing.assert_allclose(o[f"user:{k}"], o[f"fused:{k}"],
                                       rtol=0, atol=TOL, err_msg=k)


def test_user_loop_lm_against_fused_step_world_1_bitwise(port):
    inp = port[0]
    bft.init(device="cpu")
    try:
        o = lm_runs(bft, torch, inp, 0, LM_STEPS)
    finally:
        bft.shutdown()
    np.testing.assert_array_equal(o["user_losses"], o["fused_losses"])
    for k in (k for k in o if k.startswith("user:")):
        np.testing.assert_array_equal(o[k], o["fused:" + k[len("user:"):]],
                                      err_msg=k)


def test_optimizer_passes_attributes_through():
    bft.init(device="cpu")
    try:
        m = torch.nn.Linear(2, 1)
        base = torch.optim.SGD(m.parameters(), lr=0.1)
        opt = torch_frontend.DistributedTorchOptimizer(base, m)
        assert opt.param_groups is base.param_groups
        assert opt.state is base.state
        assert (opt.self_weight, opt.neighbor_weights,
                opt.send_neighbors) == (None, None, None)
        bare = torch_frontend.DistributedTorchOptimizer.__new__(
            torch_frontend.DistributedTorchOptimizer)
        with pytest.raises(AttributeError):
            bare.param_groups
    finally:
        bft.shutdown()


def test_torch_frontend_example(tmp_path):
    """The ported example through the port's launcher, four ranks."""
    repo = str(Path(__file__).resolve().parent.parent)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BFT_", "MASTER_"))
           and k not in ("WORLD_SIZE", "RANK")}
    env.update(PYTHONPATH=repo, OMP_NUM_THREADS="1",
               BFT_FLIGHT_DIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.launcher", "--simulate",
         "4", "--", sys.executable, "-m",
         "bluefog_tpu_torch.examples.torch_average_consensus"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "TORCH CONSENSUS OK" in out.stdout
    assert sorted(ln for ln in out.stdout.splitlines()
                  if ln.startswith("rank ")) == [
        f"rank {r} of 4 on device cpu" for r in range(4)]
