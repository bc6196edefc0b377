"""Nothing the harness or the reference imports is JAX or the JAX package,
compared by whole top-level names, and the reference imports nothing of
the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "bluefog_tpu"}
PORT = "bluefog_tpu_torch"


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0]"
         " for m in sys.modules}))"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax(tiny_root):
    code = (f"from portbench import harness\n"
            f"harness.run('tiny-lm.s32', 11, 0.2, True, device='cpu', "
            f"root={tiny_root!r})")
    names = _loaded(code)
    assert PORT in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port(tiny_root):
    code = ("import json, torch\n"
            "from portbench.reference import lm, resnet\n"
            "from portbench.tests.conftest import TINY_CONFIGS, TINY_CELLS\n"
            "lm.readings(TINY_CONFIGS['tiny-lm'], TINY_CELLS['tiny-lm.s32'][1],"
            " 3, torch.device('cpu'))\n"
            "resnet.readings(TINY_CONFIGS['tiny-resnet'], "
            "TINY_CELLS['tiny-resnet.b64'][1], 3, torch.device('cpu'))")
    names = _loaded(code)
    assert not names & (FORBIDDEN | {PORT})


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_under_portbench_names_jax():
    folder = os.path.join(ROOT, "portbench")
    for base, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                found = _imports(path)
                assert not found & FORBIDDEN, path
                if os.path.sep + "reference" in path:
                    assert PORT not in found, path
