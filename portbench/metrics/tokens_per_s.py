"""Tokens of all ranks trained a second, over the whole window (device
clock: the CUDA events before the first step and after the last)."""

from portbench.metrics._common import rate


def read(run):
    return rate(run, "tokens")
