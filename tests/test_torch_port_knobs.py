"""The port's environment knobs: every read is declared, every default agrees.

The port's counterpart of ``scripts/bfcheck/knob_check.py``, which scans the
JAX package only. The analyzer walks every module of ``bluefog_tpu_torch/``
and ``chip_smoke.py`` by AST and collects each environment read of a
``BFT_*`` or ``BLUEFOG_*`` name (``os.environ.get``, ``os.getenv``,
``os.environ[...]``, ``name in os.environ``) and each ``knob_env(name)``
call. It fails on a name the port's ``KNOBS`` does not declare and on a
literal default that differs from the registry's. A planted source holding
both faults must be caught, so the walk cannot pass by finding nothing.
Every declared knob stands for a knob of the JAX package with the same
type and default.
"""

import ast
import os

import pytest

from bluefog_tpu.runtime import config as jax_config
from bluefog_tpu_torch.runtime import config

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PREFIXES = ("BFT_", "BLUEFOG_")


def _mentions_environ(node) -> bool:
    while isinstance(node, ast.Attribute):
        if node.attr == "environ":
            return True
        node = node.value
    return isinstance(node, ast.Name) and node.id == "environ"


def _knob_name(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith(_PREFIXES):
        return node.value
    return None


def env_reads(src: str):
    """``(name, default node or None, line)`` of each knob read in ``src``."""
    reads = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and node.args:
            fn = node.func
            env_get = isinstance(fn, ast.Attribute) and (
                (fn.attr == "get" and _mentions_environ(fn.value))
                or (fn.attr == "getenv" and isinstance(fn.value, ast.Name)
                    and fn.value.id == "os"))
            knob_call = isinstance(fn, ast.Name) and fn.id == "knob_env"
            name = _knob_name(node.args[0])
            if name and (env_get or knob_call):
                default = node.args[1] if env_get and len(node.args) > 1 \
                    else None
                reads.append((name, default, node.lineno))
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and \
                _mentions_environ(node.value):
            name = _knob_name(node.slice)
            if name:
                reads.append((name, None, node.lineno))
        elif isinstance(node, ast.Compare) and len(node.ops) == 1 and \
                isinstance(node.ops[0], (ast.In, ast.NotIn)) and \
                _mentions_environ(node.comparators[0]):
            name = _knob_name(node.left)
            if name:
                reads.append((name, None, node.lineno))
    return reads


def _default_matches(knob, node) -> bool:
    try:
        value = ast.literal_eval(node)
    except ValueError:
        return True          # not a literal: the site computes it
    reg = knob.default
    if knob.type in ("int", "float"):
        try:
            return reg is not None and float(reg) == float(value)
        except (TypeError, ValueError):
            return False
    if knob.type == "bool":
        return bool(reg) == (value == "1" if isinstance(value, str)
                             else bool(value))
    return (reg or "") == (value or "")


def findings(src: str, rel: str) -> list:
    out = []
    for name, default, line in env_reads(src):
        try:
            k = config.knob(name)
        except KeyError:
            out.append(f"{rel}:{line}: {name} is not declared in the "
                       "port's KNOBS")
            continue
        if default is not None and not _default_matches(k, default):
            out.append(f"{rel}:{line}: {name} read with default "
                       f"{ast.unparse(default)}, the registry says "
                       f"{k.default!r}")
    return out


def _sources():
    yield os.path.join(_REPO, "chip_smoke.py")
    for d, dirs, files in os.walk(os.path.join(_REPO, "bluefog_tpu_torch")):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", "_build")]
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_port_reads_only_declared_knobs():
    bad, reads = [], 0
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            src = f.read()
        rel = os.path.relpath(path, _REPO)
        reads += len(env_reads(src))
        bad += findings(src, rel)
    assert not bad, "\n".join(bad)
    # the walk reaches the knobs the runtime reads through knob_env
    assert reads >= len(config.KNOBS)


PLANTED = '''
import os
a = os.environ.get("BFT_UNDECLARED")
b = os.getenv("BLUEFOG_TIMELINE")
c = os.environ.get("BFT_FLIGHT_CAPACITY", "1024")
d = "BFT_NOT_A_READ"
e = knob_env("BFT_TYPO")
f = "BFT_LOG_LEVEL" in os.environ
g = os.environ.get("BFT_FLIGHT_MIN_INTERVAL", 30)
'''


def test_planted_reads_are_caught():
    bad = findings(PLANTED, "planted.py")
    assert len(bad) == 4, bad
    assert any("BFT_UNDECLARED" in b for b in bad)
    assert any("BLUEFOG_TIMELINE" in b for b in bad)
    assert any("BFT_FLIGHT_CAPACITY" in b and "1024" in b for b in bad)
    assert any("BFT_TYPO" in b for b in bad)


@pytest.mark.parametrize("name", [k.name for k in config.KNOBS])
def test_knob_stands_for_a_jax_knob(name, monkeypatch):
    k = config.knob(name)
    j = jax_config.knob(k.jax_name)
    assert k.name == "BFT_" + k.jax_name[len("BLUEFOG_"):]
    assert (k.type, k.default) == (j.type, j.default)
    # typed reads, and a malformed value falls back to the default
    assert config.knob_env(name) == k.default
    if k.type in ("int", "float"):
        monkeypatch.setenv(name, "not-a-number")
        assert config.knob_env(name) == k.default
        monkeypatch.setenv(name, "7")
        assert config.knob_env(name) == 7
    with pytest.raises(KeyError):
        config.knob_env("BFT_UNDECLARED")
