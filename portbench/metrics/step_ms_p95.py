"""The 95th percentile of all the window's step times (device clock: the
intervals between the CUDA events recorded after each step). Reported
only in cells whose window holds at least 200 steps."""

from portbench.metrics._common import p95_ms as read  # noqa: F401
