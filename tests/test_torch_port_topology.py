"""Port vs JAX: the topology zoo, bit for bit.

The port keeps its own copy of ``bluefog_tpu/topology.py``; every graph
family must give the same weight matrix and circulant shift support at
n=1..16, and the dynamic one-peer iterators the same first 2n steps. An
input one package refuses, the other must refuse the same way.
"""

import itertools

import numpy as np
import pytest

from bluefog_tpu import topology as jax_topo
from bluefog_tpu_torch import topology as port_topo

GRAPHS = ["ExponentialTwoGraph", "ExponentialGraph",
          "SymmetricExponentialGraph", "MeshGrid2DGraph", "StarGraph",
          "RingGraph", "FullyConnectedGraph"]


def _outcome(mod, graph: str, n: int):
    try:
        topo = getattr(mod, graph)(n)
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return ("raises", type(exc).__name__)
    W = mod.weight_matrix(topo)
    steps = []
    for r in range(n):
        it = mod.GetDynamicSendRecvRanks(topo, r)
        try:
            steps.append([next(it) for _ in range(2 * n)])
        except Exception as exc:  # noqa: BLE001 — e.g. a rank with no peer
            steps.append(("raises", type(exc).__name__))
    return W, mod.shift_support(W), mod.shift_support(W, include_self=True), \
        steps


@pytest.mark.parametrize("graph,n", list(itertools.product(GRAPHS,
                                                           range(1, 17))))
def test_port_topology_matches_jax(graph, n):
    want = _outcome(jax_topo, graph, n)
    got = _outcome(port_topo, graph, n)
    if isinstance(want[0], str):
        assert got == want
        return
    assert got[0].dtype == want[0].dtype
    assert np.array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("world,local", [(8, 2), (8, 4), (12, 3), (16, 4)])
def test_port_machine_iterators_match_jax(world, local):
    for r in range(world):
        for fn, args in (
                ("GetExp2DynamicSendRecvMachineRanks",
                 (world, local, r, r % local)),
                ("GetInnerOuterRingDynamicSendRecvRanks", (world, local, r)),
                ("GetInnerOuterExpo2DynamicSendRecvRanks",
                 (world, local, r))):
            if local <= 2 and fn != "GetExp2DynamicSendRecvMachineRanks":
                continue
            a = getattr(jax_topo, fn)(*args)
            b = getattr(port_topo, fn)(*args)
            assert [next(a) for _ in range(2 * world)] == \
                [next(b) for _ in range(2 * world)], (fn, r)
