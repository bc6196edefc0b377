"""Logging for the port's runtime.

Counterpart of ``bluefog_tpu/runtime/logging.py``: one package logger,
``bluefog_tpu_torch``, with its level from ``BFT_LOG_LEVEL`` (trace..fatal)
and timestamps hidden by ``BFT_LOG_HIDE_TIME=1``. Every record carries
``[rank r / inc i] `` once ``bf.init`` has run, so the interleaved stderr of
a ``torchrun`` world stays attributable; the incarnation is the one the
control plane registered at attach (``BFT_INCARNATION``, 0 without one).
"""

from __future__ import annotations

import logging
import sys

from .config import knob_env

_LEVELS = {
    "trace": logging.DEBUG - 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(_LEVELS["trace"], "TRACE")

logger = logging.getLogger("bluefog_tpu_torch")


class _RankPrefixFilter(logging.Filter):
    """Injects a ``[rank r / inc i]`` prefix once ``bf.init`` has run.

    The identity is resolved per record (at import no rank exists yet), and
    any failure degrades to an empty prefix: formatting must never raise.
    """

    def filter(self, record: logging.LogRecord) -> bool:
        record.bfprefix = self._prefix()
        return True

    @staticmethod
    def _prefix() -> str:
        try:
            # no bf.init ran in a process that never imported the state
            # module (the standalone shard server runs without torch)
            state = sys.modules.get(__package__ + ".state")
            if state is None or not state._global_state().initialized:
                return ""
            from . import control_plane

            return (f"[rank {state._global_state().rank} / inc "
                    f"{control_plane.incarnation()}] ")
        except Exception:  # noqa: BLE001 — formatting must never raise
            return ""


def _configure() -> None:
    if logger.handlers:
        return
    level = _LEVELS.get(str(knob_env("BFT_LOG_LEVEL")).lower(),
                        logging.WARNING)
    fmt = "[%(levelname)s] %(bfprefix)s%(message)s" \
        if knob_env("BFT_LOG_HIDE_TIME") else \
        "%(asctime)s [%(levelname)s] %(bfprefix)s%(message)s"
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(fmt))
    handler.addFilter(_RankPrefixFilter())
    logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False


_configure()
