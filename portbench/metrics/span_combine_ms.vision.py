"""Device ms a step of the combine: the activities launched inside the
program's own ``COMBINE`` span, around ``_FusedOptimizer._combine`` (pack,
the exchange, the weighted sum, unpack)."""

from portbench.metrics._spans import launched_ms


def read(run):
    return launched_ms(run, "COMBINE")
