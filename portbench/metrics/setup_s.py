"""Seconds from the start of the run to the window's first step: imports,
the kernels' build on a first run, the model and its weights, the output
check's three steps, and the warm-up (host clock)."""


def read(run):
    return run.setup_s
