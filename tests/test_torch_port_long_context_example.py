"""The port's long-context LM example end to end on the CPU.

Counterpart of ``tests/test_long_context_example.py``: the same tiny shapes
and steps through ``python -m bluefog_tpu_torch.examples.long_context_lm``.
Ring and Ulysses context parallelism run at world 4 under ``torchrun``
(four gloo processes, a free port of its own); the flash mode trains the
full sequence at world 1 through the kernels' plain versions. Each mode
must train: the loss falls.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--seq-len", "64", "--batch-size", "2",
        "--d-model", "32", "--num-layers", "1", "--num-heads", "8",
        "--vocab", "32", "--steps", "6"]


def _run(attention: str, world: int) -> str:
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              f"--nproc_per_node={world}"] if world > 1 else \
        [sys.executable]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [*launch, "-m", "bluefog_tpu_torch.examples.long_context_lm",
         "--attention", attention, *ARGS],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def _losses(stdout: str) -> list:
    return [float(line.rsplit("loss ", 1)[1])
            for line in stdout.splitlines() if "loss " in line]


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_cp_example_trains_at_world_four(attention):
    stdout = _run(attention, 4)
    assert f"4 chip(s), seq 64 (16/chip), {attention} attention" in stdout
    losses = _losses(stdout)
    # rank 0 alone prints: steps 0 and 5, and the final line
    assert len(losses) == 3 and losses[-1] < losses[0], stdout


def test_flash_example_trains_at_world_one():
    stdout = _run("flash", 1)
    assert "full-sequence on one chip" in stdout
    losses = _losses(stdout)
    assert len(losses) >= 2 and losses[-1] < losses[0], stdout
