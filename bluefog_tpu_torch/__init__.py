"""bluefog_tpu_torch: decentralized distributed training on PyTorch and CUDA.

The port of ``bluefog_tpu`` (JAX, TPU) to PyTorch on NVIDIA Hopper. It runs
one process per rank over ``torch.distributed`` (NCCL on CUDA, gloo on the
CPU), as BlueFog itself does, and replaces global allreduce with weighted
neighbor averaging of parameters over a virtual graph, Exponential-2 by
default. The flash-attention kernels of the JAX package are hand-written
CUDA kernels here (``parallel/csrc``).

Usage mirrors ``import bluefog_tpu as bf``, with each process passing its
own tensors::

    import bluefog_tpu_torch as bf
    bf.init()                                   # device="cuda" by default
    y = bf.neighbor_allreduce(x)                # x: this rank's tensor

Names of ``bluefog_tpu`` not yet ported are absent; ROADMAP.md lists them.
"""

from . import topology as topology_util

__version__ = "0.1.0"

# lifecycle + introspection
from .runtime.state import (
    init,
    shutdown,
    size,
    local_size,
    local_rank,
    rank,
    set_topology,
    load_topology,
    is_topo_weighted,
    in_neighbor_ranks,
    out_neighbor_ranks,
)

# ops
from .ops import (
    allreduce,
    barrier,
    broadcast,
    neighbor_allreduce,
    CombinePlan,
    apply_plan,
)

# optimizer wrappers (reference: torch/optimizers.py)
from .optimizers import (
    DistributedGradientAllreduceOptimizer,
    DistributedAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer,
)

# parameter sync utilities (reference: torch/utility.py)
from .utils import broadcast_parameters, allreduce_parameters

from . import models
from . import parallel
