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
    num_machines,
    machine_size,
    is_homogeneous,
    set_topology,
    load_topology,
    is_topo_weighted,
    in_neighbor_ranks,
    out_neighbor_ranks,
    set_skip_negotiate_stage,
    get_skip_negotiate_stage,
    mpi_threads_supported,
    nccl_built,
)
from .runtime.handles import poll, synchronize, wait

# timeline (chrome tracing; ``timeline_context`` also names a
# torch.profiler range)
from .runtime.timeline import (
    start_timeline,
    stop_timeline,
    timeline_start_activity,
    timeline_end_activity,
    timeline_context,
)

# metrics registry (Prometheus text, packed snapshots, the health view)
from .runtime import metrics

# flight recorder: always-on black box, postmortem dumps, step attribution
from .runtime import flight
from .runtime.flight import step_report


def flight_dump(reason: str = "explicit", path=None):
    """Dump the flight recorder now (the ring's tail and a metrics
    snapshot) to ``bf_flight_<rank>.json`` under ``BFT_FLIGHT_DIR``, or to
    ``path``; returns the path written."""
    return flight.dump(reason=reason, path=path, force=True)


# ops
from .ops import (
    allreduce,
    allreduce_,
    allreduce_nonblocking,
    allreduce_nonblocking_,
    broadcast,
    broadcast_,
    broadcast_nonblocking,
    broadcast_nonblocking_,
    allgather,
    allgather_nonblocking,
    allgather_v,
    allgather_v_nonblocking,
    pair_gossip,
    pair_gossip_nonblocking,
    barrier,
    neighbor_allreduce,
    neighbor_allreduce_nonblocking,
    hierarchical_neighbor_allreduce,
    hierarchical_neighbor_allreduce_nonblocking,
    neighbor_allgather,
    neighbor_allgather_nonblocking,
    CombinePlan,
    apply_plan,
)

# optimizer wrappers (reference: torch/optimizers.py)
from .optimizers import (
    DistributedGradientAllreduceOptimizer,
    DistributedAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer,
    DistributedHierarchicalNeighborAllreduceOptimizer,
    DistributedShardedAllreduceOptimizer,
)

# parameter sync utilities (reference: torch/utility.py)
from .utils import (broadcast_parameters, allreduce_parameters,
                    broadcast_optimizer_state)

from . import checkpoint
from . import models
from . import parallel
