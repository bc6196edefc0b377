"""The ResNet step's share of the card's bf16 peak, in %: the frozen
model FLOPs of a step (``counts/resnet.py``) times the window's steps over
its device time."""

from portbench.counts import resnet
from portbench.metrics._common import mfu


def read(run):
    spec = run.cell.job["inputs"]
    return mfu(run, resnet.step_flops(run.cell.config, int(spec["batch"]))
               * int(run.cell.job["world"]))
