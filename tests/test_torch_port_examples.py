"""The port's examples end to end on the CPU, held to JAX's where JAX's
example computes the same thing.

  * ``optimization.py`` at world 4 (gloo children) on the ring instance of
    ``tests/test_optimization.py`` (``generate_data(PRNGKey(7), 4, 20, 5,
    "linear_regression")``, rho 1e-2), the same numpy ``X, y`` for both:
    after 20 steps, distributed gradient descent and each decentralized
    method's iterate on every rank equal JAX's rank-stacked one to 1e-5; at
    the JAX tests' budgets (gradient tracking 200, not 150: at world 4 JAX
    itself is 1.8e-3 from the optimum after 150 and 2.6e-4 after 200)
    every rank converges as they require (exact diffusion and gradient
    tracking to 1e-3 of the centralized optimum, diffusion within its
    O(alpha) bias of 0.5); two nonblocking handles in flight;
    ``push_diging`` raises and names the examples' window item;
  * ``make_lr_schedule`` equal to JAX's at every step of 90 epochs;
  * every example through its entry point in one ``torchrun`` world of 4
    (``_torch_port_child.py examples``): ``average_consensus.py``
    (``CONSENSUS OK``), ``moe.py`` (``MOE OK`` and ``MOE_LM OK``),
    ``benchmark.py --model mlp`` (its ``Total img/sec`` line parsed, as
    ``tests/test_benchmark_smoke.py`` does), ``mnist.py`` for one epoch,
    ``optimization.py``, and a short ``resnet.py`` run with a checkpoint
    per epoch and a resume that runs exactly the remaining epoch (JAX's
    counterpart, ``tests/test_resnet_example.py``, is marked slow at world
    8; this one is not);
  * the window kinds of ``benchmark.py`` and ``resnet.py`` raise.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

import bluefog_tpu as bf
from conftest import cpu_devices
from _torch_port_child import run_world

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "examples"))
import optimization as jax_opt  # noqa: E402
import resnet as jax_resnet  # noqa: E402

from bluefog_tpu_torch.examples import benchmark as port_benchmark  # noqa: E402
from bluefog_tpu_torch.examples import resnet as port_resnet  # noqa: E402

N = 4
CMP_STEPS = 20
METHODS = {"diffusion": 0.05, "exact_diffusion": 0.1,
           "gradient_tracking": 0.05}


@pytest.fixture(scope="module")
def problem():
    X, y = jax_opt.generate_data(jax.random.PRNGKey(7), N, 20, 5,
                                 task="linear_regression")
    return np.asarray(X, np.float32), np.asarray(y, np.float32)


@pytest.fixture(scope="module")
def port_run(problem, tmp_path_factory):
    X, y = problem
    d = tmp_path_factory.mktemp("torch_port_optimization")
    np.savez(d / "inputs.npz", X=X, y=y, cmp_steps=CMP_STEPS)
    return run_world("optimization", str(d), world=N, timeout=240)


@pytest.fixture(scope="module")
def jax_run(problem):
    X, y = problem
    bf.init(devices=cpu_devices(N))
    try:
        jax_opt.set_example_topology("ring")
        grad_fn = jax_opt.make_grad_fn(X, y, "linear_regression", rho=1e-2)
        out = {"cmp_dgd": jax_opt.distributed_grad_descent(
            grad_fn, N, 5, maxite=CMP_STEPS, alpha=0.1)}
        for name, alpha in METHODS.items():
            out[f"cmp_{name}"], _ = jax_opt.ALGORITHMS[name](
                grad_fn, out["cmp_dgd"], N, 5, maxite=CMP_STEPS,
                alpha=alpha)
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        bf.shutdown()


@pytest.mark.parametrize("key", ["cmp_dgd"] + [f"cmp_{m}" for m in METHODS])
def test_optimization_iterates_match_jax(key, port_run, jax_run):
    for rank in range(N):
        np.testing.assert_allclose(port_run[rank][key], jax_run[key][rank],
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("method", list(METHODS))
def test_optimization_converges(method, port_run):
    """JAX's ``tests/test_optimization.py`` limits, on every rank."""
    for rank in range(N):
        got = port_run[rank]
        assert np.linalg.norm(got["w_opt_global_grad"]) < 1e-4
        err = np.linalg.norm(got[f"conv_{method}"] - got["w_opt"])
        mse = got[f"mse_{method}"]
        if method == "diffusion":
            assert err < 0.5
        else:
            assert err < 1e-3 and (mse[-1] < mse[0] * 1e-1 or mse[0] < 1e-3)


def test_optimization_overlap_and_push_diging(port_run):
    for rank in range(N):
        got = port_run[rank]
        assert got["flag:overlap_handles_differ"] == 1
        assert got["overlap_w"].shape == (5, 1)
        assert got["overlap_q"].shape == got["overlap_q_in"].shape
        assert got["flag:push_diging"] == 1


def test_lr_schedule_matches_jax_at_every_step():
    for argv, size in ((["--base-lr", "0.1", "--warmup-epochs", "5",
                         "--steps-per-epoch", "10"], 8),
                       (["--batches-per-allreduce", "3",
                         "--warmup-epochs", "2.5"], 3)):
        ja, pa = jax_resnet.parse_args(argv), port_resnet.parse_args(argv)
        spe = ja.steps_per_epoch
        want = np.asarray(jax.vmap(jax_resnet.make_lr_schedule(ja, size, spe))(
            np.arange(90 * spe + 5)))
        sched = port_resnet.make_lr_schedule(pa, size, spe)
        got = np.array([sched(s) for s in range(90 * spe + 5)], np.float32)
        np.testing.assert_array_equal(got, want)


def _resnet_args(tmp_path, **over):
    base = dict(device="cpu", epochs=2, batch_size=4, val_batch_size=4,
                base_lr=0.004, warmup_epochs=2, steps_per_epoch=6, classes=4,
                image_size=32, checkpoint_format=str(tmp_path / "ck-{epoch}"))
    base.update(over)
    argv = []
    for k, v in base.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return port_resnet.parse_args(argv)


def test_window_kinds_raise_with_the_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        port_benchmark.main(["--device", "cpu", "--dist-optimizer",
                             "push_sum"])
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        port_resnet.train(_resnet_args(tmp_path, dist_optimizer="win_put"))


def test_optimization_run_follows_the_runtime_device():
    """``optimization.run`` without ``device`` runs where ``bf.init`` put
    the runtime (the card unless the caller asked for the CPU), not on the
    CPU regardless."""
    import inspect

    import torch

    import bluefog_tpu_torch as bft
    from bluefog_tpu_torch.examples import optimization as port_opt
    from bluefog_tpu_torch.runtime.state import _global_state

    assert inspect.signature(port_opt.run).parameters["device"].default \
        is None
    bft.init(device="cpu")
    try:
        w, w_opt, mse = port_opt.run(method="gradient_tracking",
                                     task="linear_regression", maxite=40)
        want = _global_state().device
    finally:
        bft.shutdown()
    assert w.device == w_opt.device == want == torch.device("cpu")
    assert mse[-1] < mse[0]


@pytest.fixture(scope="module")
def examples_run(tmp_path_factory):
    """rank 0's output of every example in one torchrun world of 4."""
    d = tmp_path_factory.mktemp("torch_port_examples")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={N}",
         str(REPO / "tests" / "_torch_port_child.py"), "examples", str(d)],
        env=env, cwd=str(d), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout, d


def test_average_consensus_at_world_four(examples_run):
    stdout, _ = examples_run
    assert f"ranks: {N} on cpu" in stdout
    assert "CONSENSUS OK" in stdout


def test_moe_at_world_four(examples_run):
    stdout, _ = examples_run
    assert f"experts: {N} on cpu" in stdout
    assert "MOE OK" in stdout and "MOE_LM OK" in stdout, stdout


def test_benchmark_mlp_at_world_four(examples_run):
    stdout, _ = examples_run
    assert "dynamic_topology=True" in stdout
    m = re.search(r"Total img/sec on (\d+) chip\(s\):\s*([0-9.]+) \+-",
                  stdout)
    assert m and int(m.group(1)) == N and float(m.group(2)) > 0, stdout


def test_mnist_and_optimization_at_world_four(examples_run):
    stdout, _ = examples_run
    losses = re.findall(r"epoch 0: mean loss ([0-9.]+)", stdout)
    assert len(losses) == 1 and np.isfinite(float(losses[0])), stdout
    assert "accuracy of consensus model" in stdout
    err = re.search(r"\[gradient_tracking\] final \|\|w - w_opt\|\|: "
                    r"([0-9.e+-]+)", stdout)
    assert err and float(err.group(1)) < 1e-3, stdout


def test_resnet_checkpoints_and_resumes_at_world_four(examples_run):
    stdout, d = examples_run
    epochs = re.findall(r"^epoch (\d+): loss ([0-9.]+) val_acc", stdout,
                        re.M)
    assert [e for e, _ in epochs] == ["0", "1", "2"], stdout
    assert all(np.isfinite(float(x)) for _, x in epochs)
    assert f"resumed from {d / 'ck-2'} at epoch 2" in stdout
    assert all((d / f"ck-{e}").is_dir() for e in (1, 2, 3))
