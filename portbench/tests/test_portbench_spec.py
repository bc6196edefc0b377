"""The benchmark's description: every file loads, every name and unit is
well formed, every per-layer metric moves a metric its cells report, a
tail stands only where a window holds enough steps, and a cell, a
configuration and a metric are added as new files and entries."""

from __future__ import annotations

import hashlib
import json
import os

import pytest

from portbench.tests.conftest import ROOT

from portbench.spec import NAME, UNIT, Spec

ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    return Spec(ROOT)


def test_top_level_keys(spec):
    assert set(spec.bench) == {"command", "paths", "run_seconds", "configs",
                               "workloads", "end_to_end", "per_layer"}
    assert spec.bench["command"] == ["python3", "portbench/run.py"]
    assert spec.bench["paths"] == ["portbench"]
    assert 1 <= spec.bench["run_seconds"] <= 51
    assert len(json.dumps(spec.bench)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_have_the_contract_keys(spec, section):
    for entry in spec.bench[section]:
        extra = set(entry) - ENTRY_KEYS[section] - (
            {"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert set(entry) >= ENTRY_KEYS[section] and not extra, entry["name"]


def test_names_and_units(spec):
    b = spec.bench
    names = [e["name"] for s in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in b[s]]
    names += [w["config"] for w in b["workloads"]]
    names += [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        own = [e["name"] for e in b[section]]
        assert len(own) == len(set(own)), section
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in b["workloads"] + b["configs"]]
                 + [m["layer"] for m in b["per_layer"]]
                 + [c["source"] for c in b["configs"]] + b["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds(spec):
    for m in spec.bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in spec.bench["end_to_end"])


def test_every_cell_config_and_metric_loads(spec):
    for name in spec.cell_names:
        cell = spec.cell(name)
        assert cell.job["world"] * 1 >= 1 and cell.job["limits"]
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer
    for metric in spec.metrics:
        assert callable(spec.reader(metric))


def test_config_files(spec):
    for entry in spec.bench["configs"]:
        assert entry["file"].startswith("portbench/configs/")
        with open(os.path.join(ROOT, entry["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"]
        for key in entry["reduced"]:
            assert key in cfg and cfg["published"][key] != cfg[key], key


def test_per_layer_moves_a_metric_its_cells_report(spec):
    e2e = {m["name"]: m for m in spec.bench["end_to_end"]}
    layers = {}
    for m in spec.bench["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m["workloads"]:
            assert m["moves"] in spec.cell(cell).end_to_end, (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(NAME.match(m) for ms in layers.values() for m in ms)


def test_tail_only_where_the_window_holds_200_steps(spec):
    seconds = spec.bench["run_seconds"]
    for name in spec.cell_names:
        cell = spec.cell(name)
        steps = seconds * 1000.0 / cell.job["predicted_step_ms"]
        if "step_ms_p95" in cell.end_to_end:
            assert steps >= 200, name
        if cell.job["inputs"]["kind"] == "tokens":
            assert "step_ms_p95" not in cell.end_to_end, name


def test_at_most_a_quarter_of_the_cells_on_four_chips(spec):
    four = [w for w in spec.bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(spec.bench["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in spec.bench["workloads"])


def _digests(root: str) -> dict:
    out = {}
    for base, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            if "__pycache__" not in base:
                path = os.path.join(base, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_cells_configs_and_metrics_are_added_as_new_files(tmp_path):
    """A copy of the benchmark gains two configurations, two cells and a
    metric as new files and entries; no file of the copy changes."""
    import shutil

    from portbench.tests.conftest import add_tiny_cells

    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    add_tiny_cells(root)
    with open(os.path.join(root, "portbench", "metrics", "steps.py"), "w") as f:
        f.write("def read(run):\n    return run.steps\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "steps", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "harness entry",
        "moves": "tokens_per_s", "workloads": ["tiny-lm.s32"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
    spec = Spec(root)
    cell = spec.cell("tiny-lm.s32")
    assert cell.config["hidden_size"] == 64
    assert "steps" in cell.per_layer and "tokens_per_s" in cell.end_to_end
    assert spec.reader("steps")(type("R", (), {"steps": 7})()) == 7
    assert "images_per_s" in spec.cell("tiny-resnet.b64").end_to_end
