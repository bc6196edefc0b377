"""Process-level runtime state: lifecycle, rank introspection, topology.

Counterpart of ``bluefog_tpu/runtime/state.py``. The JAX package runs every
rank as one SPMD program over a device mesh; the port runs ONE PROCESS PER
RANK over ``torch.distributed`` — the execution model of BlueFog itself
(reference: basics.py:47-65 over MPI). NCCL carries the traffic when the
device is CUDA, gloo when it is the CPU.

``init`` joins an existing process group when one is already up, else forms
one from (in order) explicit ``init_method``/``rank``/``world_size``
arguments, a launcher's environment (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``,
as ``torchrun`` sets them), or — with neither — a world of one over a
``FileStore`` in a fresh temporary directory (never a fixed port, so
concurrent jobs on one host cannot collide).

Entry points run on ``cuda`` by default. With no GPU present they raise and
say to pass ``device="cpu"``; nothing quietly carries on on the CPU.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import List, Optional

import networkx as nx
import torch
import torch.distributed as dist

from .. import topology as topology_util
from . import flight as _flight
from . import handles
from . import metrics as _metrics
from .config import knob_env
from .logging import logger


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU. Raises when CUDA is asked for (explicitly or by default)
    and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bluefog_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class _State:
    def __init__(self) -> None:
        self.initialized = False
        self.size = 0
        self.rank = 0
        self.local_rank = 0
        self.local_size = 1
        self.device: Optional[torch.device] = None
        self.topology: Optional[nx.DiGraph] = None
        self.is_topo_weighted = False
        self.owns_group = False
        self.store_dir: Optional[str] = None
        self.skip_negotiate = False
        # this rank's machine subgroups (``dist.group.WORLD`` when one spans
        # every rank); None without a homogeneous layout
        self.local_group = None
        self.machine_group = None
        # the gloo group ``checkpoint`` coordinates over, made at first use
        self.checkpoint_group = None
        self.timeline = None
        self._plan_cache: dict = {}

    def check_initialized(self) -> None:
        if not self.initialized:
            raise RuntimeError(
                "bluefog_tpu_torch is not initialized; call bf.init() first")

    def check_homogeneous(self) -> None:
        """Hierarchical ops need every machine to hold ``local_size`` ranks
        (the reference requires is_homogeneous too, mpi_ops.py:693-741)."""
        self.check_initialized()
        if self.local_group is None:
            raise RuntimeError(
                f"hierarchical ops need a homogeneous machine layout; size "
                f"{self.size} is not a multiple of local_size "
                f"{self.local_size}")


_state = _State()


def _global_state() -> _State:
    return _state


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def init(
    topology_fn=None,
    is_weighted: bool = False,
    *,
    device=None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_size: Optional[int] = None,
) -> None:
    """Join (or form) the process group and install the initial topology.

    Analog of ``bf.init(topology_fn, is_weighted)`` (reference:
    basics.py:47-65). ``topology_fn(size) -> nx.DiGraph`` defaults to
    ``ExponentialTwoGraph``, as in the JAX package.

    Args:
      device: ``"cuda"`` (default) or ``"cpu"``; picks NCCL or gloo.
      init_method: a ``torch.distributed`` URL (``file://...`` or
        ``tcp://host:port``); with ``rank`` and ``world_size``.
      local_size: ranks per machine for the hierarchical ops (default:
        ``LOCAL_WORLD_SIZE``, else the world size). Rank r sits on machine
        ``r // local_size`` at local index ``r % local_size``, torchrun's
        layout and the JAX machine mesh's.
    """
    st = _state
    if st.initialized:
        shutdown()
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"

    if dist.is_available() and dist.is_initialized():
        owns = False
    else:
        owns = True
        if init_method is not None:
            if rank is None or world_size is None:
                raise ValueError("init_method needs rank and world_size")
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=world_size)
        elif _env_int("WORLD_SIZE") is not None and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            st.store_dir = tempfile.mkdtemp(prefix="bft_store_")
            store = dist.FileStore(os.path.join(st.store_dir, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1)
    st.owns_group = owns
    st.size = dist.get_world_size()
    st.rank = dist.get_rank()
    env_local_size = _env_int("LOCAL_WORLD_SIZE")
    env_local_rank = _env_int("LOCAL_RANK")
    st.local_size = int(local_size or env_local_size or st.size)
    st.local_rank = env_local_rank if env_local_rank is not None and \
        local_size is None else st.rank % st.local_size
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            st.local_rank % torch.cuda.device_count()
        dev = torch.device("cuda", idx)
        torch.cuda.set_device(dev)
    st.device = dev
    _make_subgroups(st)
    # A fresh telemetry epoch for the job: the instruments zero in place,
    # the flight ring starts anew (a dump belongs to THIS job), and an
    # uncaught exception leaves a dump behind.
    _metrics.reset_for_job()
    _flight.reset_for_job()
    _flight.install_excepthook()
    st._plan_cache = {}
    st.topology = None
    st.initialized = True

    if topology_fn is not None:
        topo = topology_fn(st.size)
    else:
        topo = topology_util.ExponentialTwoGraph(st.size)
        is_weighted = False
    if not set_topology(topo, is_weighted=is_weighted):
        raise RuntimeError("failed to set initial topology")
    prefix = knob_env("BFT_TIMELINE")
    if prefix:
        from .timeline import Timeline

        st.timeline = Timeline(prefix, process_index=st.rank)
    # BFT_METRICS_INTERVAL / BFT_METRICS_PROM: the cadence thread
    _metrics.start_publisher_if_needed()
    logger.info("bluefog_tpu_torch initialized: rank %d of %d on %s (%s)",
                st.rank, st.size, st.device, dist.get_backend())


def shutdown() -> None:
    """Tear down runtime state; destroys the process group if ``init``
    created it (reference: operations.cc:1205-1215)."""
    st = _state
    if not st.initialized:
        return
    if _metrics.publication_enabled():
        # final flush: a short job still leaves a current scrape
        try:
            _metrics.publish_now()
        except Exception:  # noqa: BLE001 — teardown must not raise
            pass
    _metrics.stop_publisher()
    # close open per-op spans BEFORE the timeline so the trace stays
    # balanced (every B gets its E edge)
    handles.close_all_spans()
    if st.timeline is not None:
        st.timeline.close()
        st.timeline = None
    _flight.uninstall_excepthook()
    if st.owns_group and dist.is_initialized():
        dist.destroy_process_group()
    if st.store_dir is not None:
        shutil.rmtree(st.store_dir, ignore_errors=True)
        st.store_dir = None
    st._plan_cache.clear()
    st.local_group = st.machine_group = st.checkpoint_group = None
    st.skip_negotiate = False
    st.topology = None
    st.initialized = False
    handles.clear()


def _make_subgroups(st: _State) -> None:
    """One local group per machine and one machine group per local index
    (ranks ``{m * L + l : m}``), created by every rank in the same order as
    ``dist.new_group`` requires. A group that spans the world is the world.
    Without a homogeneous layout both stay None (JAX keeps no machine mesh
    then, ``bluefog_tpu/runtime/state.py:214-229``)."""
    st.local_group = st.machine_group = None
    n, L = st.size, st.local_size
    if n % L:
        logger.warning("size %d not divisible by local_size %d; "
                       "hierarchical ops disabled", n, L)
        return
    m = n // L

    def group(ranks):
        return dist.group.WORLD if len(ranks) == n else dist.new_group(ranks)

    local = [group([k * L + l for l in range(L)]) for k in range(m)]
    machine = [group([k * L + l for k in range(m)]) for l in range(L)]
    st.local_group = local[st.rank // L]
    st.machine_group = machine[st.rank % L]


# -- introspection (parity: basics.py:120-186) -----------------------------

def size() -> int:
    _state.check_initialized()
    return _state.size


def local_size() -> int:
    _state.check_initialized()
    return _state.local_size


def num_machines() -> int:
    _state.check_initialized()
    return _state.size // _state.local_size


def machine_size() -> int:
    """The number of machines, as the JAX package answers it."""
    return num_machines()


def is_homogeneous() -> bool:
    """Every machine holds ``local_size`` ranks (reference:
    mpi_controller.cc:71-96)."""
    _state.check_initialized()
    return _state.size % _state.local_size == 0


def rank() -> int:
    """This process's rank (one process per rank, as in the reference)."""
    _state.check_initialized()
    return _state.rank


def local_rank() -> int:
    """This process's index among the ranks of its host."""
    _state.check_initialized()
    return _state.local_rank


# -- topology management (parity: basics.py:188-291) -----------------------

def set_topology(topology: Optional[nx.DiGraph] = None,
                 is_weighted: bool = False) -> bool:
    """Install a new virtual topology; returns False if rejected (wrong
    node count or not a DiGraph). An equivalent topology is a no-op."""
    st = _state
    st.check_initialized()
    if topology is None:
        topology = topology_util.ExponentialTwoGraph(st.size)
        is_weighted = False
    if not isinstance(topology, nx.DiGraph):
        logger.error("set_topology requires a networkx.DiGraph")
        return False
    if topology.number_of_nodes() != st.size:
        logger.error("topology has %d nodes but runtime has %d ranks",
                     topology.number_of_nodes(), st.size)
        return False
    if (st.topology is not None
            and topology_util.IsTopologyEquivalent(topology, st.topology)
            and is_weighted == st.is_topo_weighted):
        return True
    st.topology = topology
    st.is_topo_weighted = is_weighted
    st._plan_cache.clear()
    return True


def load_topology() -> nx.DiGraph:
    _state.check_initialized()
    return _state.topology


def is_topo_weighted() -> bool:
    _state.check_initialized()
    return _state.is_topo_weighted


def in_neighbor_ranks(rank_: Optional[int] = None) -> List[int]:
    """Sorted in-neighbors of ``rank_`` (default: this process's rank)."""
    _state.check_initialized()
    r = _state.rank if rank_ is None else rank_
    return topology_util.in_neighbor_ranks(_state.topology, r)


def out_neighbor_ranks(rank_: Optional[int] = None) -> List[int]:
    _state.check_initialized()
    r = _state.rank if rank_ is None else rank_
    return topology_util.out_neighbor_ranks(_state.topology, r)


def set_skip_negotiate_stage(value: bool) -> None:
    """Skip the ops' eager cross-rank checks (reference: basics.py:293-306).
    The port's negotiate stage is one small all-gather of each tensor's
    shape and dtype before ``allgather``, which turns a mismatch across
    ranks into a ``ValueError`` instead of a hang."""
    _state.check_initialized()
    _state.skip_negotiate = bool(value)


def get_skip_negotiate_stage() -> bool:
    _state.check_initialized()
    return _state.skip_negotiate


def mpi_threads_supported() -> bool:
    """True, as in the JAX package: ops may be issued from any thread
    (the reference asks MPI for MPI_THREAD_MULTIPLE, basics.py:129-143)."""
    return True


def nccl_built() -> bool:
    """Whether ``torch.distributed`` has NCCL, the transport the port uses
    on CUDA (the JAX package answers False: it has no NCCL)."""
    return dist.is_available() and dist.is_nccl_available()
