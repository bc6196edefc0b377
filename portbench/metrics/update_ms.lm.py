"""Device ms a step of the update: the activities launched inside the
``portbench.update`` range that the harness opens around the optimizer
instance's ``base.step`` (``torch.optim``'s Adam or SGD)."""

from portbench.metrics._common import update_ms as read  # noqa: F401
