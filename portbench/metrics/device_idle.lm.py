"""The share of the traced window in which no kernel, copy or set ran on
the card, in %: 1 - (union of their intervals) / window."""

from portbench.metrics._common import device_idle as read  # noqa: F401
