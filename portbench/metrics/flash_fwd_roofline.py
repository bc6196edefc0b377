"""K1's share of its roofline, in %: the least time of the forward kernel
at the cell's [B, S, H, D] (``counts/flash.py``) times its launches in the
traced window, over the device time of the kernels named
``flash_fwd_kernel``."""

from portbench.metrics._flash import roofline


def read(run):
    return roofline(run, ("flash_fwd",))
