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
    unified_mpi_window_model_supported,
)
from .runtime.handles import poll, synchronize, wait

# failure detection, coordinated shutdown and membership across
# controllers (runtime/heartbeat.py), and the control plane's typed
# failures (runtime/native.py); a synchronize whose deadline passes with a
# controller dead raises PeerLostError
from .runtime.heartbeat import (
    dead_controllers,
    dead_ranks,
    membership_epoch,
    shutdown_requested,
    suspect_controllers,
)
from .runtime.native import (PeerLostError, QuorumLostError,
                             StaleIncarnationError)

# timeline (chrome tracing; ``timeline_context`` also names a
# torch.profiler range while a profiler runs)
from .runtime.timeline import (
    start_timeline,
    stop_timeline,
    timeline_start_activity,
    timeline_end_activity,
    timeline_context,
)

# metrics registry (Prometheus text, packed snapshots, the health view)
from .runtime import metrics
from .runtime.metrics import cluster_health

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

# one-sided window ops and push-sum (ops/windows.py): the collective plane
# over the process group, the hosted plane over the control plane
from .ops import (
    win_create,
    win_free,
    win_put,
    win_put_nonblocking,
    win_accumulate,
    win_accumulate_nonblocking,
    win_get,
    win_get_nonblocking,
    win_update,
    win_update_then_collect,
    win_fence,
    win_poll,
    win_wait,
    get_win_version,
    win_mutex,
    win_lock,
    win_associated_p,
    win_associated_p_all,
    turn_on_win_ops_with_associated_p,
    turn_off_win_ops_with_associated_p,
)

# optimizer wrappers (reference: torch/optimizers.py)
from .optimizers import (
    DistributedGradientAllreduceOptimizer,
    DistributedAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer,
    DistributedHierarchicalNeighborAllreduceOptimizer,
    DistributedShardedAllreduceOptimizer,
    DistributedWinPutOptimizer,
    DistributedPullGetOptimizer,
    DistributedPushSumOptimizer,
)

# parameter sync utilities (reference: torch/utility.py) and the
# torchvision converters
from .utils import (broadcast_parameters, allreduce_parameters,
                    broadcast_optimizer_state, resnet_from_torch,
                    vgg_from_torch)

from . import checkpoint
from . import models
from . import parallel

# serving plane: versioned snapshots and batched read-only inference over
# the control-plane wire; ``bf.serve_client()`` attaches from inside a job
from .serving import RequestShed, ServeClient, serve_client
