"""The port's knob registry: every environment knob it reads.

Counterpart of the registry in ``bluefog_tpu/runtime/config.py``
(:79-655). The port reads its knobs under its own ``BFT_`` prefix, so a job
that runs both packages on one host configures each apart; every knob
records the ``BLUEFOG_*`` knob of the JAX package it stands for
(``jax_name``) and keeps that knob's default. Only the knobs the port reads
are declared. ``tests/test_torch_port_knobs.py`` walks the port's sources
and fails on a read of an undeclared ``BFT_*`` or ``BLUEFOG_*`` name, or on
a read whose literal default differs from the registry's.

The port's launcher environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``LOCAL_WORLD_SIZE``, ``LOCAL_RANK``) and ``CUDA_HOME`` are not knobs of the
package: they come from ``torchrun`` and the CUDA toolkit.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Knob:
    """One declared environment knob.

    ``type`` is one of ``int``/``float``/``str``/``bool``/``path``
    (``bool`` knobs are the ``"0"``/``"1"`` convention). ``default`` is the
    typed default (None = unset: the site decides). ``jax_name`` is the
    JAX package's knob this one stands for.
    """

    name: str
    type: str
    default: object
    doc: str
    jax_name: str


KNOBS: Tuple[Knob, ...] = (
    Knob("BFT_LOG_LEVEL", "str", "warn",
         "trace / debug / info / warn / error / fatal",
         "BLUEFOG_LOG_LEVEL"),
    Knob("BFT_LOG_HIDE_TIME", "bool", False,
         "`1` hides timestamps in log lines", "BLUEFOG_LOG_HIDE_TIME"),
    Knob("BFT_TIMELINE", "path", None,
         "path prefix → enable the chrome-tracing timeline at `bf.init` "
         "(one file `<prefix><rank>.json` per process)",
         "BLUEFOG_TIMELINE"),
    Knob("BFT_METRICS_INTERVAL", "float", None,
         "seconds between metrics publications (the Prometheus file; the "
         "timeline's counter tracks). Unset/0 disables publication — "
         "collection is always on",
         "BLUEFOG_METRICS_INTERVAL"),
    Knob("BFT_METRICS_PROM", "path", None,
         "path of a Prometheus text-exposition file, rewritten atomically "
         "on the metrics cadence (implies a 10 s cadence when "
         "`BFT_METRICS_INTERVAL` is unset)", "BLUEFOG_METRICS_PROM"),
    Knob("BFT_STRAGGLER_STEPS", "int", 3,
         "step-counter spread at which the health view flags a rank as a "
         "straggler", "BLUEFOG_STRAGGLER_STEPS"),
    Knob("BFT_FLIGHT_CAPACITY", "int", 8192,
         "event capacity of the always-on flight-recorder ring; rounded up "
         "to a power of two", "BLUEFOG_FLIGHT_CAPACITY"),
    Knob("BFT_FLIGHT_DIR", "path", None,
         "directory flight-recorder dumps (`bf_flight_<rank>.json`) are "
         "written to; default: the current working directory",
         "BLUEFOG_FLIGHT_DIR"),
    Knob("BFT_FLIGHT_DISABLE", "bool", False,
         "`1` turns flight recording off entirely",
         "BLUEFOG_FLIGHT_DISABLE"),
    Knob("BFT_FLIGHT_MIN_INTERVAL", "float", 30.0,
         "rate limit (seconds) between automatic flight dumps (fatal "
         "optimizer steps); an explicit `bf.flight_dump()` bypasses it",
         "BLUEFOG_FLIGHT_MIN_INTERVAL"),
)

_KNOB_INDEX = {k.name: k for k in KNOBS}


def knob(name: str) -> Knob:
    """The declared :class:`Knob` for ``name`` (KeyError if undeclared)."""
    return _KNOB_INDEX[name]


def knob_default(name: str):
    """The registry's default for ``name``."""
    return _KNOB_INDEX[name].default


def knob_env(name: str):
    """Read ``name`` from the environment, typed per its declaration.

    Returns the registry default when unset (None for unset knobs); raises
    KeyError for an undeclared name. A malformed value falls back to the
    default rather than raising, as in the JAX package.
    """
    k = _KNOB_INDEX[name]
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return k.default
    try:
        if k.type == "int":
            return int(raw)
        if k.type == "float":
            return float(raw)
        if k.type == "bool":
            return raw == "1"
    except ValueError:
        return k.default
    return raw
