"""The LM step's share of the card's bf16 peak, in %: the frozen model
FLOPs of a step (``counts/lm.py``) times the window's steps over its
device time."""

from portbench.counts import lm
from portbench.metrics._common import mfu


def read(run):
    spec = run.cell.job["inputs"]
    return mfu(run, lm.step_flops(run.cell.config, int(spec["batch"]),
                                  int(spec["seq_len"])) * int(run.cell.job["world"]))
