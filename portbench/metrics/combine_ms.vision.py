"""Device ms a step of the combine: the activities launched inside the
``portbench.combine`` range that the harness opens around the optimizer
instance's ``_combine`` (pack, the shifts' sends and receives, the weighted
sum, unpack)."""

from portbench.metrics._common import combine_ms as read  # noqa: F401
