"""The 95th percentile of the traced window's step times in an LM cell,
whose window holds too few steps for a tail to repeat end to end."""

from portbench.metrics._common import p95_ms as read  # noqa: F401
