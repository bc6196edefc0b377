"""A run's last line, its output check against the planted faults, and its
control, on the tiny cells on the CPU; the control at the cells' own
sizes on the card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import calibrate, check, harness
from portbench.spec import Spec
from portbench.tests.conftest import ROOT

TINY = ["tiny-lm.s32", "tiny-resnet.b64"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", TINY)
@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_contract_keys(tiny_root, cell, trace):
    result, _ = harness.run(cell, 2 ** 35 + 9, 0.3, trace, device="cpu",
                            root=tiny_root)
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["attempted"] > 0
    assert result["failed"] == 0
    device = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["device"]) == device | (
        {"busy_s", "window_s"} if trace else set())
    spec = Spec(tiny_root)
    want = spec.cell(cell).per_layer if trace else spec.cell(cell).end_to_end
    assert set(result["metrics"]) <= set(want)
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == spec.unit(name)
    assert list(result["checks"]) == list(spec.cell(cell).job["limits"])
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(result)


@pytest.mark.parametrize("cell", TINY)
@pytest.mark.parametrize("fault", harness.FAULTS)
def test_a_broken_step_is_not_correct(tiny_root, cell, fault):
    result, _ = harness.run(cell, 2 ** 35 + 21, 0.2, False, device="cpu",
                            root=tiny_root, faults=(fault,))
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", TINY)
def test_the_control_is_not_correct(tiny_root, cell):
    """The reference from float8 operands, in the program's place, fails
    the tiny cell's limits on each of three seeds."""
    spec = Spec(tiny_root)
    c = spec.cell(cell)
    _, reference = harness.modules(c.config["builder"])
    for seed in (1, 2, 3):
        ref = reference.readings(c.config, c.job, seed, torch.device("cpu"))
        low = reference.readings(c.config, c.job, seed, torch.device("cpu"),
                                 precision="fp8")
        assert not check.passed(check.compare(low, ref, c.job["limits"]))


@pytest.mark.card
@pytest.mark.parametrize("cell", Spec().cell_names)
def test_the_control_is_not_correct_on_the_card(card, cell):
    """At the cell's own size, on three seeds: the control fails the
    cell's limits, the program passes them."""
    c = Spec().cell(cell)
    rows = []
    calibrate.calibrate(c, [2 ** 34 + 100 + i for i in range(3)],
                        torch.device("cuda"), control=3, faults=0,
                        emit=rows.append)
    for row in rows:
        checks = {n: {"value": row[n], "limit": limit}
                  for n, limit in c.job["limits"].items()}
        assert check.passed(checks) == (row["kind"] == "program"), row


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "resnet50.b256",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_without_the_program(tmp_path):
    """In a folder with only BENCHMARK.json and the benchmark's files."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "resnet50.b256",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""
