"""The benchmark's description: ``BENCHMARK.json`` and the files it names.

Every configuration, cell and metric is found by its name, so a later cell,
configuration or metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration and job."""

    name: str
    config_name: str
    chips: int
    config: dict             # configs/<config>.json
    job: dict                # cells/<cell>.json
    end_to_end: List[str]    # the end-to-end metrics this cell reports
    per_layer: List[str]     # the per-layer metrics this cell reports


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` under ``root`` and the files under its first path."""

    def __init__(self, root: str = ROOT) -> None:
        self.root = root
        self.bench = _load_json(os.path.join(root, "BENCHMARK.json"))
        self.folder = os.path.join(root, self.bench["paths"][0])
        self.metrics: Dict[str, dict] = {
            m["name"]: m for m in self.bench["end_to_end"] + self.bench["per_layer"]}
        self._readers: Dict[str, Callable] = {}

    @property
    def cell_names(self) -> List[str]:
        return [w["name"] for w in self.bench["workloads"]]

    def _reports(self, metric: dict, cell: str) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        if metric in self.bench["per_layer"]:
            return self._reports(self.metrics[metric["moves"]], cell)
        return True

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {self.cell_names})")
        config = next(c for c in self.bench["configs"]
                      if c["name"] == entry["config"])
        return Cell(
            name=name, config_name=entry["config"], chips=int(entry["chips"]),
            config=_load_json(os.path.join(self.root, config["file"])),
            job=_load_json(os.path.join(self.folder, "cells", f"{name}.json")),
            end_to_end=[m["name"] for m in self.bench["end_to_end"]
                        if self._reports(m, name)],
            per_layer=[m["name"] for m in self.bench["per_layer"]
                       if self._reports(m, name)])

    def reader(self, metric: str) -> Callable:
        """``read(run) -> float | None`` of ``metrics/<metric>.py``."""
        if metric not in self._readers:
            path = os.path.join(self.folder, "metrics", f"{metric}.py")
            mod_name = "portbench_metric_" + re.sub(r"\W", "_", metric)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[metric] = mod.read
        return self._readers[metric]

    def unit(self, metric: str) -> str:
        return self.metrics[metric]["unit"]

