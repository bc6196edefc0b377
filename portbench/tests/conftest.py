"""Fixtures of the benchmark's tests: a copy of the benchmark with tiny
cells added as new files and entries (no file of the copy is edited), and
the marker of the tests that need a card."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_CONFIGS = {
    "tiny-lm": {"source": "a tiny LM for the CPU tests", "builder": "lm",
                "hidden_size": 64, "num_attention_heads": 2,
                "intermediate_size": 256, "num_hidden_layers": 2,
                "vocab_size": 128, "rotary_emb_base": 10000,
                "block": {"rms_norm_eps": 1e-06}, "reduced": []},
    "tiny-resnet": {"source": "a tiny ResNet for the CPU tests",
                    "builder": "resnet", "stage_sizes": [1, 1],
                    "num_filters": 16, "num_classes": 10, "image_size": 32,
                    "bn_eps": 1e-05, "reduced": []},
}
# Limits of the tiny cells, from CPU runs on seeds 1-3 (loss, grad,
# change gaps): the LM's sound runs read at most 2.6e-4, 1.4e-3 and
# 1.7e-3, a half batch at least 0.021, 0.40 and 0.13; the ResNet's (two
# blocks, batch norm in bf16, whose backward makes the gradients' gaps
# wide at this size) at most 5e-4, 0.13 and 0.19, its control at least
# 2.9e-3, 0.10 and 0.09, a half batch 0.027, 0.47 and 0.43; a state left
# unchanged reads 1 in the last two.
LM_LIMITS = {"loss_gap": 0.002, "grad_gap": 0.02, "change_gap": 0.02}
RESNET_LIMITS = {"loss_gap": 0.0015, "grad_gap": 0.4, "change_gap": 0.4}
TINY_CELLS = {
    "tiny-lm.s32": ("tiny-lm", {
        "world": 1, "topology": "exp2",
        "optimizer": {"name": "adam", "lr": 0.001, "betas": [0.9, 0.999],
                      "eps": 1e-08},
        "inputs": {"kind": "tokens", "batch": 4, "seq_len": 32},
        "pool": 4, "predicted_step_ms": 10, "limits": LM_LIMITS}),
    "tiny-lm.s32.x2": ("tiny-lm", {
        "world": 2, "topology": "exp2",
        "optimizer": {"name": "adam", "lr": 0.001, "betas": [0.9, 0.999],
                      "eps": 1e-08},
        "inputs": {"kind": "tokens", "batch": 4, "seq_len": 32},
        "pool": 4, "predicted_step_ms": 10, "limits": LM_LIMITS}),
    "tiny-resnet.b64": ("tiny-resnet", {
        "world": 1, "topology": "exp2",
        "optimizer": {"name": "sgd", "lr": 0.1, "momentum": 0.9},
        "inputs": {"kind": "images", "batch": 64, "size": 32},
        "pool": 4, "predicted_step_ms": 10, "limits": RESNET_LIMITS}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    """Skip, with the reason, where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")


def add_tiny_cells(root: str) -> None:
    """Add the tiny configurations and cells to the benchmark under ``root``
    as new files and new entries of its ``BENCHMARK.json``."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    folder = os.path.join(root, bench["paths"][0])
    for name, cfg in TINY_CONFIGS.items():
        file = f"{bench['paths'][0]}/configs/{name}.json"
        with open(os.path.join(root, file), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": cfg["source"],
                                 "file": file, "reduced": [], "why": "tests"})
    for name, (config, job) in TINY_CELLS.items():
        with open(os.path.join(folder, "cells", f"{name}.json"), "w") as f:
            json.dump(job, f)
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": name.split(".", 1)[1],
                                   "chips": 1, "why": "tests"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            family = "lm" if config == "tiny-lm" else "vision"
            kinds = {"tokens_per_s": "lm", "images_per_s": "vision",
                     "step_ms_p95": "vision"}
            mine = kinds.get(metric["name"], metric["name"].rsplit(".", 1)[-1])
            if "workloads" in metric and (
                    mine == family or metric["name"].startswith("flash_")
                    and family == "lm"):
                metric["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with the tiny cells added."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_tiny_cells(root)
    return root
