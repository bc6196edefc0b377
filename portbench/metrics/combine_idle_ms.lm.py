"""Ms a step of the traced window in which the host is inside the program's
``COMBINE`` span and nothing runs on the card: the time the combine makes
the card wait (the span's intervals less the union of the device's)."""

from portbench.metrics._spans import idle_ms


def read(run):
    return idle_ms(run, "COMBINE")
