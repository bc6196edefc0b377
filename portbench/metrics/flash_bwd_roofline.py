"""K2 and K3's share of their roofline, in %: the least times of the two
backward kernels at the cell's [B, S, H, D] (``counts/flash.py``) times
their launches in the traced window, over the device time of the kernels
named ``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel``."""

from portbench.metrics._flash import roofline


def read(run):
    return roofline(run, ("flash_bwd_dq", "flash_bwd_dkv"))
