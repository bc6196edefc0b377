"""Port vs JAX: neighbor averaging and collectives at world 4.

The port runs as four gloo processes (one per rank, FileStore rendezvous
under ``tmp_path``); the JAX package runs the same rank-constant inputs on
its 4-device CPU mesh. f32 results must agree to 1e-6 (the same weighted
sums in another order); the bf16 case to one bf16 ulp (both accumulate in
f32 and round once at the end, so only an f32 tie can flip the rounding).
"""

import numpy as np
import pytest

import bluefog_tpu as bf
from bluefog_tpu import topology as topology_util
from bluefog_tpu.ops.plan import CombinePlan, apply_plan
from conftest import cpu_devices
from _torch_port_child import run_world

N = 4


def _inputs():
    rng = np.random.default_rng(1234)
    return rng.standard_normal((N, 3, 5)).astype(np.float32)


@pytest.fixture(scope="module")
def port_outputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_port_ops")
    np.savez(d / "inputs.npz", x=_inputs())
    return run_world("ops", str(d), world=N)


@pytest.fixture(scope="module")
def jax_outputs():
    import jax.numpy as jnp

    x = _inputs()
    bf.init(devices=cpu_devices(N))
    try:
        n = N
        nested = {r: {(r - 1) % n: 0.3, (r - 2) % n: 0.2} for r in range(n)}
        out = {
            "static": bf.neighbor_allreduce(x),
            "weighted": bf.neighbor_allreduce(
                x, self_weight=0.5, neighbor_weights=nested),
            "dynamic": bf.neighbor_allreduce(
                x, self_weight=0.5,
                neighbor_weights={r: {(r - 1) % n: 0.5} for r in range(n)},
                send_neighbors={r: [(r + 1) % n] for r in range(n)}),
            "bf16": bf.neighbor_allreduce(
                jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32),
            "allreduce_avg": bf.allreduce(x),
            "allreduce_sum": bf.allreduce(x, average=False),
            "broadcast": bf.broadcast(x, root_rank=2),
        }
        W = np.zeros((n, n))
        for r in range(n):
            W[r, r] = 1.0 / 3
            for src in topology_util.in_neighbor_ranks(bf.load_topology(), r):
                W[src, r] = 1.0 / 3
        out["gather"] = apply_plan(CombinePlan(W, force_gather=True),
                                   bf.mesh(), "rank", x)
        bf.set_topology(topology_util.RingGraph(n), is_weighted=True)
        out["weighted_topo"] = bf.neighbor_allreduce(x)
        return {k: np.asarray(v, np.float32) for k, v in out.items()}
    finally:
        bf.shutdown()


@pytest.mark.parametrize("case", [
    "static", "weighted", "dynamic", "gather", "bf16", "allreduce_avg",
    "allreduce_sum", "broadcast", "weighted_topo"])
def test_port_ops_match_jax(case, port_outputs, jax_outputs):
    want = jax_outputs[case]
    atol = 2.0 ** -8 * np.abs(want).max() if case == "bf16" else 1e-6
    for r in range(N):
        np.testing.assert_allclose(port_outputs[r][case], want[r], rtol=0,
                                   atol=atol, err_msg=f"{case} rank {r}")
