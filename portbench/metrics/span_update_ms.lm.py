"""Device ms a step of the update: the activities launched inside the
program's own ``UPDATE`` span, which ``_FusedOptimizer._step`` opens around
``base.step()`` (``torch.optim``'s Adam or SGD)."""

from portbench.metrics._spans import launched_ms


def read(run):
    return launched_ms(run, "UPDATE")
