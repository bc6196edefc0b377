"""Virtual-topology zoo for decentralized averaging.

The port's own copy of ``bluefog_tpu/topology.py`` (numpy and networkx only,
kept line for line so the two packages build bit-equal weight matrices; the
port never imports the JAX package). It provides the same graph families and
dynamic one-peer iterators as BlueFog's ``bluefog/common/topology_util.py``
(reference: topology_util.py:66-554): every graph is a weighted
``networkx.DiGraph`` whose adjacency matrix ``W`` has the "combine" convention

    x_new[j] = sum_i W[i, j] * x[i]

i.e. ``W[i, j]`` is the weight rank ``j`` applies to the value received from
rank ``i`` (edge i -> j). Column-stochastic W => average-preserving push
(push-sum); row-stochastic W^T rows => each rank's combine weights sum to 1.

The useful structural fact is that every circulant graph here (ring,
exponential-2, symmetric-exponential, fully-connected) decomposes into a small
set of *shifts*: edge set {(i, (i+s) mod n) for all i} per shift s. A shift is
exactly one ``batch_isend_irecv`` round between process ranks, so the combine
plans computed by :func:`shift_support` / :func:`weight_matrix` drive the
collective implementation in ``bluefog_tpu_torch.ops.plan``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import networkx as nx
import numpy as np

__all__ = [
    "IsTopologyEquivalent",
    "IsRegularGraph",
    "GetRecvWeights",
    "GetSendWeights",
    "ExponentialTwoGraph",
    "ExponentialGraph",
    "SymmetricExponentialGraph",
    "MeshGrid2DGraph",
    "StarGraph",
    "RingGraph",
    "FullyConnectedGraph",
    "GetDynamicSendRecvRanks",
    "GetExp2DynamicSendRecvMachineRanks",
    "GetInnerOuterRingDynamicSendRecvRanks",
    "GetInnerOuterExpo2DynamicSendRecvRanks",
    "weight_matrix",
    "shift_support",
    "in_neighbor_ranks",
    "out_neighbor_ranks",
    "dynamic_weight_matrix",
    "prune_dead_ranks",
    "readmit_ranks",
]


# ---------------------------------------------------------------------------
# Construction helpers
# ---------------------------------------------------------------------------

def _circulant_digraph(first_row: np.ndarray) -> nx.DiGraph:
    """DiGraph whose adjacency is the circulant matrix generated by first_row.

    Row i is ``first_row`` rotated right by i, so W[i, (i+s) % n] =
    first_row[s]: every rank sends to the same set of relative shifts.
    """
    n = len(first_row)
    adj = np.empty((n, n), dtype=np.float64)
    for i in range(n):
        adj[i] = np.roll(first_row, i)
    return nx.from_numpy_array(adj, create_using=nx.DiGraph)


def _is_power_of(x: int, base: int) -> bool:
    if x <= 0:
        return False
    while x % base == 0:
        x //= base
    return x == 1


# ---------------------------------------------------------------------------
# Static graph zoo (parity: topology_util.py:66-303)
# ---------------------------------------------------------------------------

def ExponentialTwoGraph(size: int) -> nx.DiGraph:
    """Each rank i connects to i + 2^k (mod size) for all k, uniform weights.

    The flagship BlueFog topology (reference: topology_util.py:66-87).
    """
    assert size > 0
    row = np.array(
        [1.0 if i == 0 or _is_power_of(i, 2) else 0.0 for i in range(size)]
    )
    row /= row.sum()
    return _circulant_digraph(row)


def ExponentialGraph(size: int, base: int = 2) -> nx.DiGraph:
    """Generalized exponential graph: connect at distances base^k.

    Reference: topology_util.py:99-125.
    """
    assert isinstance(base, int) and base > 1
    row = np.array(
        [1.0 if i == 0 or _is_power_of(i, base) else 0.0 for i in range(size)]
    )
    row /= row.sum()
    return _circulant_digraph(row)


def SymmetricExponentialGraph(size: int, base: int = 4) -> nx.DiGraph:
    """Exponential connectivity mirrored around size//2.

    Reference: topology_util.py:128-157.
    """
    row = np.zeros(size)
    row[0] = 1.0
    for i in range(1, size):
        d = i if i <= size // 2 else size - i
        if _is_power_of(d, base):
            row[i] = 1.0
    row /= row.sum()
    return _circulant_digraph(row)


def MeshGrid2DGraph(size: int, shape: Optional[Tuple[int, int]] = None) -> nx.DiGraph:
    """2D grid with Metropolis-Hastings weights (doubly-stochastic).

    Reference: topology_util.py:160-211 (Hastings rule per arXiv:1702.05122).
    """
    assert size > 0
    if shape is None:
        nrow = int(np.sqrt(size))
        while size % nrow != 0:
            nrow -= 1
        shape = (nrow, size // nrow)
    nrow, ncol = shape
    assert nrow * ncol == size, "shape does not match size"

    adj = np.zeros((size, size))
    for i in range(size):
        adj[i, i] = 1.0
        if (i + 1) % ncol != 0:  # right neighbor in same row
            adj[i, i + 1] = adj[i + 1, i] = 1.0
        if i + ncol < size:  # neighbor in next row
            adj[i, i + ncol] = adj[i + ncol, i] = 1.0

    degree_with_self = [len(np.nonzero(adj[i])[0]) for i in range(size)]
    for i in range(size):
        for j in np.nonzero(adj[i])[0]:
            if i != j:
                adj[i, j] = 1.0 / max(degree_with_self[i], degree_with_self[j])
        adj[i, i] = 2.0 - adj[i].sum()
    return nx.from_numpy_array(adj, create_using=nx.DiGraph)


def StarGraph(size: int, center_rank: int = 0) -> nx.DiGraph:
    """Bidirectional star around center_rank. Reference: topology_util.py:214-237."""
    assert size > 0
    adj = np.zeros((size, size))
    for i in range(size):
        adj[i, i] = 1.0 - 1.0 / size
        adj[center_rank, i] = 1.0 / size
        adj[i, center_rank] = 1.0 / size
    return nx.from_numpy_array(adj, create_using=nx.DiGraph)


def RingGraph(size: int, connect_style: int = 0) -> nx.DiGraph:
    """Ring graph; style 0 = bidirectional, 1 = left only, 2 = right only.

    Reference: topology_util.py:240-281.
    """
    assert size > 0
    assert 0 <= connect_style <= 2, "connect_style must be 0 (bi), 1 (left), 2 (right)"
    if size == 1:
        return nx.from_numpy_array(np.array([[1.0]]), create_using=nx.DiGraph)
    if size == 2:
        return nx.from_numpy_array(
            np.array([[0.5, 0.5], [0.5, 0.5]]), create_using=nx.DiGraph
        )
    row = np.zeros(size)
    if connect_style == 0:
        row[0] = row[1] = row[-1] = 1.0 / 3.0
    elif connect_style == 1:
        row[0] = row[-1] = 0.5
    else:
        row[0] = row[1] = 0.5
    return _circulant_digraph(row)


def FullyConnectedGraph(size: int) -> nx.DiGraph:
    """All-to-all with uniform 1/size weights. Reference: topology_util.py:284-303."""
    assert size > 0
    return _circulant_digraph(np.full(size, 1.0 / size))


# ---------------------------------------------------------------------------
# Introspection helpers (parity: topology_util.py:23-63, 306-312)
# ---------------------------------------------------------------------------

def IsTopologyEquivalent(topo1: Optional[nx.DiGraph], topo2: Optional[nx.DiGraph]) -> bool:
    """Adjacency matrices exactly equal (not isomorphism). Ref: topology_util.py:23-37."""
    if topo1 is None or topo2 is None:
        return False
    if topo1.number_of_nodes() != topo2.number_of_nodes():
        return False
    if topo1.number_of_edges() != topo2.number_of_edges():
        return False
    a1 = nx.to_numpy_array(topo1)
    a2 = nx.to_numpy_array(topo2)
    return bool((a1 == a2).all())


def IsRegularGraph(topo: nx.DiGraph) -> bool:
    """All nodes share the same degree. Ref: topology_util.py:306-312."""
    degree = topo.degree(0)
    return all(topo.degree(r) == degree for r in range(1, topo.number_of_nodes()))


def GetRecvWeights(topo: nx.DiGraph, rank: int) -> Tuple[float, Dict[int, float]]:
    """(self_weight, {in_neighbor: weight}) for combining received values.

    Ref: topology_util.py:40-50.
    """
    W = nx.to_numpy_array(topo)
    self_weight = 0.0
    neighbor_weights: Dict[int, float] = {}
    for src in topo.predecessors(rank):
        if src == rank:
            self_weight = float(W[src, rank])
        else:
            neighbor_weights[src] = float(W[src, rank])
    return self_weight, neighbor_weights


def GetSendWeights(topo: nx.DiGraph, rank: int) -> Tuple[float, Dict[int, float]]:
    """(self_weight, {out_neighbor: weight}) for outgoing sends.

    Ref: topology_util.py:53-63.
    """
    W = nx.to_numpy_array(topo)
    self_weight = 0.0
    neighbor_weights: Dict[int, float] = {}
    for dst in topo.successors(rank):
        if dst == rank:
            self_weight = float(W[rank, dst])
        else:
            neighbor_weights[dst] = float(W[rank, dst])
    return self_weight, neighbor_weights


def in_neighbor_ranks(topo: nx.DiGraph, rank: int) -> List[int]:
    """Sorted in-neighbors of rank, excluding self.

    The sorted order is the neighbor-ordering contract inherited from
    MPI_Dist_graph_create_adjacent semantics (reference: torch/mpi_ops.cc:374-380).
    """
    return sorted(r for r in topo.predecessors(rank) if r != rank)


def out_neighbor_ranks(topo: nx.DiGraph, rank: int) -> List[int]:
    """Sorted out-neighbors of rank, excluding self."""
    return sorted(r for r in topo.successors(rank) if r != rank)


# ---------------------------------------------------------------------------
# TPU combine plans
# ---------------------------------------------------------------------------

def weight_matrix(topo: nx.DiGraph) -> np.ndarray:
    """Dense [n, n] combine matrix W with W[i, j] = weight of edge i -> j."""
    return nx.to_numpy_array(topo)


def shift_support(W: np.ndarray, include_self: bool = False) -> List[int]:
    """Distinct circulant shifts s (1..n-1) with any nonzero W[i, (i+s) % n].

    Each returned shift is one ``ppermute`` round on the rank axis; circulant
    graphs (ring / expo2) have O(log n) of them. Shift 0 (self edge) is
    excluded unless include_self.
    """
    n = W.shape[0]
    shifts = []
    lo = 0 if include_self else 1
    for s in range(lo, n):
        if any(W[i, (i + s) % n] != 0.0 for i in range(n)):
            shifts.append(s)
    return shifts


def dynamic_weight_matrix(
    size: int,
    send_neighbors: Dict[int, List[int]],
    self_weight=None,  # float | Dict[int, float]; required with neighbor_weights
    neighbor_weights: Optional[Dict[int, Dict[int, float]]] = None,
) -> np.ndarray:
    """Build a per-step combine matrix from per-rank dynamic send lists.

    ``send_neighbors[r]`` is the list of destinations rank r sends to this
    step (the per-process ``send_neighbors`` argument of the reference's
    dynamic neighbor_allreduce, mpi_ops.py:426-438, assembled for all ranks).
    Weights default to uniform 1/(indegree+1) on the receiving side.
    """
    W = np.zeros((size, size))
    recv_from: Dict[int, List[int]] = {r: [] for r in range(size)}
    for src, dsts in send_neighbors.items():
        for dst in dsts:
            recv_from[dst].append(src)
    for dst in range(size):
        srcs = recv_from[dst]
        if neighbor_weights is not None and dst in neighbor_weights:
            for src, w in neighbor_weights[dst].items():
                W[src, dst] = w
            if self_weight is None:
                raise ValueError(
                    "self_weight is required when neighbor_weights is given"
                )
            if isinstance(self_weight, dict):
                if dst not in self_weight:
                    raise ValueError(f"self_weight missing entry for rank {dst}")
                W[dst, dst] = self_weight[dst]
            else:
                W[dst, dst] = float(self_weight)
        else:
            u = 1.0 / (len(srcs) + 1)
            for src in srcs:
                W[src, dst] = u
            W[dst, dst] = u
    return W


def prune_dead_ranks(topo: nx.DiGraph, dead) -> nx.DiGraph:
    """Shrink a topology around dead ranks, renormalizing averaging weights.

    The self-healing gossip primitive (cf. AD-PSGD / SGP: decentralized
    averaging tolerates vertex removal while the live subgraph stays
    connected): every edge touching a dead rank is removed — nodes are kept
    so rank indexing stays stable — and each surviving rank's remaining
    in-edge weights (its self-loop included) are rescaled by one factor so
    its column sum is preserved. Column-stochastic inputs therefore stay
    column-stochastic over the live set, which is exactly the
    mass-conservation property push-sum needs; uniform-averaging inputs
    stay convex combinations. Dead ranks keep a unit self-loop so the
    matrix remains well-formed for any code that inspects it.

    Returns ``topo`` itself when ``dead`` is empty (the hot path allocates
    nothing); raises when every rank is dead.

    The pruned graph carries a prune record (``G.graph["_bf_prune"]``:
    the ORIGINAL combine matrix plus the accumulated dead set), so pruning
    composes — ``prune(prune(G, d1), d2)`` prunes the original around
    ``d1 | d2``, a double-prune with the same set is exactly idempotent —
    and :func:`readmit_ranks` can invert it exactly when ranks rejoin.
    """
    dead = set(dead)
    if not dead:
        return topo
    n = topo.number_of_nodes()
    record = topo.graph.get("_bf_prune")
    if record is not None:
        # composing prunes: always re-derive from the ORIGINAL matrix
        W = np.array(record["W"])
        dead = dead | set(record["dead"])
    else:
        W = nx.to_numpy_array(topo)
    if not (set(range(n)) - dead):
        raise ValueError("prune_dead_ranks: every rank is dead")
    live = np.array([r not in dead for r in range(n)])
    Wp = np.zeros_like(W)
    for j in range(n):
        if not live[j]:
            Wp[j, j] = 1.0
            continue
        col = W[:, j] * live
        total, live_total = W[:, j].sum(), col.sum()
        if live_total > 0:
            Wp[:, j] = col * (total / live_total)
        else:
            # every in-edge (and the self weight) pointed at corpses:
            # degrade to holding the current value
            Wp[j, j] = total if total > 0 else 1.0
    out = nx.from_numpy_array(Wp, create_using=nx.DiGraph)
    out.graph["_bf_prune"] = {"W": W.copy(), "dead": sorted(dead)}
    return out


def readmit_ranks(topo: nx.DiGraph, ranks,
                  original: Optional[nx.DiGraph] = None) -> nx.DiGraph:
    """Re-expand a pruned topology around ranks returning to service.

    The inverse of :func:`prune_dead_ranks` (column-renormalized
    re-expansion): the readmitted ranks' original in/out edges are restored
    and every affected column's weights return to their pre-prune split, so
    ``readmit_ranks(prune_dead_ranks(G, d), d)`` reproduces ``G`` exactly.
    Partially readmitting (``ranks`` a strict subset of the pruned set)
    yields the original pruned around the still-dead remainder.

    The pre-prune edge structure comes from the prune record
    :func:`prune_dead_ranks` stashes on its result, or from ``original``
    (the unpruned graph) when the record is unavailable (e.g. the pruned
    matrix traveled through serialization that drops graph attributes).
    """
    ranks = set(ranks)
    if not ranks:
        return topo
    record = topo.graph.get("_bf_prune")
    if record is not None:
        W = np.array(record["W"])
        dead = set(record["dead"])
    elif original is not None:
        W = nx.to_numpy_array(original)
        dead = set()
        # infer the pruned set: ranks reduced to a bare unit self-loop
        Wp = nx.to_numpy_array(topo)
        for j in range(Wp.shape[0]):
            col_off = np.sum(Wp[:, j]) - Wp[j, j]
            row_off = np.sum(Wp[j, :]) - Wp[j, j]
            if col_off == 0 and row_off == 0 and Wp[j, j] == 1.0:
                dead.add(j)
    else:
        raise ValueError(
            "readmit_ranks: the pruned graph carries no prune record and "
            "no `original` topology was given — the readmitted ranks' "
            "pre-prune edges cannot be reconstructed")
    unknown = ranks - dead
    if unknown:
        raise ValueError(
            f"readmit_ranks: ranks {sorted(unknown)} are not in the pruned "
            f"set {sorted(dead)}")
    remaining = dead - ranks
    base = nx.from_numpy_array(W, create_using=nx.DiGraph)
    if not remaining:
        return base
    return prune_dead_ranks(base, remaining)


def demote_in_edges(topo: nx.DiGraph, rank: int, drop_srcs) -> nx.DiGraph:
    """Drop some of one rank's in-edges, renormalizing its column.

    The self-tuning controller's in-degree lever (ISSUE r16): a sustained
    straggler stops waiting on (some of) its in-neighbors — the dropped
    in-edge weights are redistributed over the rank's REMAINING in-edges
    and self-loop by one column scale factor, so the column sum (the mass
    push-sum conserves; the convex-combination property uniform averaging
    needs) is preserved exactly, the same construction
    :func:`prune_dead_ranks` applies around dead ranks. Only ``rank``'s
    column changes: the demoted sources keep sending elsewhere, and
    nothing about ``rank``'s out-edges moves.

    The result carries a demote record (``G.graph["_bf_demote"]``: the
    ORIGINAL matrix plus the per-rank dropped-source map), so demotions
    compose across ranks and repeat calls, and :func:`promote_rank` can
    invert one rank's demotion exactly — the round-trip
    ``promote_rank(demote_in_edges(G, r, S), r)`` reproduces ``G``.
    The self-loop is never dropped; raises when the drop set would leave
    the column with nothing to renormalize onto.
    """
    drop = {int(s) for s in drop_srcs} - {int(rank)}
    if not drop:
        return topo
    n = topo.number_of_nodes()
    record = topo.graph.get("_bf_demote")
    if record is not None:
        # composing demotions: always re-derive from the ORIGINAL matrix
        W = np.array(record["W"])
        demoted = {int(r): set(v) for r, v in record["demoted"].items()}
    else:
        W = nx.to_numpy_array(topo)
        demoted = {}
    demoted[int(rank)] = demoted.get(int(rank), set()) | drop
    Wd = W.copy()
    for j, drops in demoted.items():
        keep = np.ones(n, bool)
        for s in drops:
            keep[s] = False
        keep[j] = True
        col = W[:, j]
        total, kept_total = col.sum(), (col * keep).sum()
        if kept_total <= 0:
            raise ValueError(
                f"demote_in_edges: dropping in-edges {sorted(drops)} of "
                f"rank {j} leaves no weight to renormalize onto")
        Wd[:, j] = col * keep * (total / kept_total)
    out = nx.from_numpy_array(Wd, create_using=nx.DiGraph)
    out.graph["_bf_demote"] = {
        "W": W.copy(),
        "demoted": {r: sorted(v) for r, v in demoted.items()}}
    return out


def promote_rank(topo: nx.DiGraph, rank: int) -> nx.DiGraph:
    """Restore one rank's demoted in-edges (inverse of
    :func:`demote_in_edges`): its column returns to the exact pre-demote
    weights; other ranks' demotions, if any, are re-applied from the
    original matrix. A rank with no demote record is returned unchanged —
    promote is idempotent, so the controller's recovery path needs no
    bookkeeping about whether its demotion ever actuated."""
    record = topo.graph.get("_bf_demote")
    if record is None:
        return topo
    demoted = {int(r): set(v) for r, v in record["demoted"].items()}
    if int(rank) not in demoted:
        return topo
    del demoted[int(rank)]
    W = np.array(record["W"])
    base = nx.from_numpy_array(W, create_using=nx.DiGraph)
    if not demoted:
        return base
    out = base
    for r, drops in demoted.items():
        out = demote_in_edges(out, r, drops)
    return out


# ---------------------------------------------------------------------------
# Dynamic one-peer iterators (parity: topology_util.py:315-554)
# ---------------------------------------------------------------------------

def GetDynamicSendRecvRanks(
    topo: nx.DiGraph, self_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Cycle through out-neighbors clockwise, one send peer per step.

    Yields (send_ranks, recv_ranks) per step; recv set is derived from every
    other rank running the same schedule. Ref: topology_util.py:315-357.
    """
    size = topo.number_of_nodes()

    def clockwise(rank: int) -> List[int]:
        order = sorted(
            topo.successors(rank),
            key=lambda r: (r - rank) % size if r != rank else 0,
        )
        return [r for r in order if r != rank]

    schedule = [clockwise(r) for r in range(size)]
    index = 0
    while True:
        my = schedule[self_rank]
        send_rank = my[index % len(my)]
        recv_ranks = [
            other
            for other in range(size)
            if other != self_rank
            and schedule[other][index % len(schedule[other])] == self_rank
        ]
        yield [send_rank], recv_ranks
        index += 1


def GetExp2DynamicSendRecvMachineRanks(
    world_size: int, local_size: int, self_rank: int, local_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """One-peer Expo-2 schedule at machine granularity.

    Homogeneous setups only (same local_size everywhere).
    Ref: topology_util.py:360-397.
    """
    assert self_rank % local_size == local_rank, "homogeneous environment required"
    assert world_size % local_size == 0, "homogeneous environment required"
    assert world_size > local_size, "needs at least two machines"

    machine_id = self_rank // local_size
    num_machines = world_size // local_size
    exp2_size = int(np.log2(num_machines - 1)) if num_machines > 1 else 0
    index = 0
    while True:
        dist = 2 ** (index % (exp2_size + 1))
        yield [(machine_id + dist) % num_machines], [(machine_id - dist) % num_machines]
        index += 1


def GetInnerOuterRingDynamicSendRecvRanks(
    world_size: int, local_size: int, self_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Inner-ring within a machine, outer-ring across machines, one peer/step.

    Each step one designated local rank bridges to the next machine; everyone
    else walks the intra-machine ring skipping the bridge rank.
    Ref: topology_util.py:399-463.
    """
    num_machines = world_size // local_size
    assert world_size % local_size == 0, "homogeneous environment required"
    assert local_size > 2, "needs >2 ranks per machine; use GetDynamicSendRecvRanks"

    machine_id = self_rank // local_size
    local_id = self_rank % local_size
    index = 0
    while True:
        bridge = index % local_size
        if bridge == local_id:
            send = ((machine_id + 1) % num_machines) * local_size + local_id
            recv = ((machine_id - 1) % num_machines) * local_size + local_id
        else:
            t = (local_id + 1) % local_size
            if t == bridge:
                t = (t + 1) % local_size
            send = machine_id * local_size + t
            s = (local_id - 1) % local_size
            if s == bridge:
                s = (s - 1) % local_size
            recv = machine_id * local_size + s
        yield [send], [recv]
        index += 1


def GetInnerOuterExpo2DynamicSendRecvRanks(
    world_size: int, local_size: int, self_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Inner-Expo2 within a machine, outer-Expo2 across machines, one peer/step.

    The flagship dynamic schedule (drives the reference's headline benchmark).
    Ref: topology_util.py:466-554.
    """
    num_machines = world_size // local_size
    assert world_size % local_size == 0, "homogeneous environment required"
    assert local_size > 2, "needs >2 ranks per machine; use GetDynamicSendRecvRanks"

    exp2_out = int(np.log2(num_machines - 1)) if num_machines > 1 else 0
    exp2_in = 0 if local_size == 2 else int(np.log2(local_size - 2))

    machine_id = self_rank // local_size
    local_id = self_rank % local_size
    index = 0
    while True:
        bridge = index % local_size
        if bridge == local_id:
            dist = 2 ** (index % (exp2_out + 1))
            send = ((machine_id + dist) % num_machines) * local_size + local_id
            recv = ((machine_id - dist) % num_machines) * local_size + local_id
        else:
            fwd = 2 ** (index % (exp2_in + 1))
            if fwd >= (bridge - local_id) % local_size:
                fwd += 1
            send = machine_id * local_size + (local_id + fwd) % local_size

            back = 2 ** (index % (exp2_in + 1))
            if back >= (local_id - bridge) % local_size:
                back += 1
            recv = machine_id * local_size + (local_id - back) % local_size
        yield [send], [recv]
        index += 1
