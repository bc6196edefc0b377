"""Port vs JAX: machine subgroups and the rest of the collectives surface.

First the subgroup repair: ``spmd_combine(group=...)`` over the subgroups
{0, 2} and {1, 3} of a world-4 gloo job, whose group ranks are not their
global ranks, must equal the 2-rank combine of those ranks' inputs.

Then every op, at world 4 (2 machines of 2 ranks) and world 6 (2 machines
of 3, as ``tests/test_odd_world_sizes.py:153``): the port runs as gloo
processes, one per rank, on numpy inputs from a seed, and the JAX package
runs the same calls on its CPU mesh (``bf.init(devices=..., local_size=L)``).
The cases mirror ``tests/test_ops.py``: the hierarchical-local allreduce,
allgather and allgather_v (ragged, all-empty, mismatched),
``hierarchical_neighbor_allreduce`` (default and machine weights),
``neighbor_allgather`` (regular Expo-2 and an irregular star) and
``pair_gossip`` (weights, a rank paired with itself, the mismatch error).
The same runs check the nonblocking forms through ``poll``/``synchronize``/
``wait`` (a second ``synchronize`` raises; a deadline that passes keeps
the handle for a retry) and the in-place ``_`` forms writing into their
input.

Tolerances: f32 to 1e-6 (the same sums in another order); bf16 reductions
to one bf16 ulp of the largest value (both accumulate in f32 and round once,
so only an f32 tie can flip the rounding); gathers and ``pair_gossip`` in
bf16 exactly (``pair_gossip`` computes in bf16 on both sides).
"""

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu import topology as topology_util
from conftest import cpu_devices
from _torch_port_child import run_world

WORLDS = {4: 2, 6: 3}      # world size: ranks per machine (2 machines)
W_PAIR = np.array([[0.7, 0.4], [0.3, 0.6]])   # the subgroups' combine

EXACT = {"allgather_bf16", "pair_bf16", "pair_bf16_odd"}
BF16 = {"hier_local_bf16", "hier_bf16"}
# port case -> the JAX result it must equal
CASES = {
    "hier_local_avg": "hier_local_avg", "hier_local_sum": "hier_local_sum",
    "hier_local_bf16": "hier_local_bf16", "allgather": "allgather",
    "allgather_bf16": "allgather_bf16", "allgather_v": "allgather_v",
    "allgather_v_empty": "allgather_v_empty", "hier": "hier",
    "hier_weights": "hier_weights", "hier_bf16": "hier_bf16",
    "nag_expo2": "nag_expo2", "nag_star": "nag_star", "pair": "pair",
    "pair_w": "pair_w", "pair_bf16": "pair_bf16",
    "pair_bf16_odd": "pair_bf16_odd", "pair_self": "pair_self",
    "nb_allreduce": "allreduce", "nb_hier_local": "hier_local_avg",
    "nb_broadcast": "broadcast", "nb_allgather": "allgather",
    "nb_allgather_v": "allgather_v", "nb_pair": "pair_w", "nb_nar": "nar",
    "nb_hier": "hier", "nb_nag_expo2": "nag_expo2",
    "nb_nag_star": "nag_star", "inplace_allreduce": "allreduce",
    "inplace_hier_local": "hier_local_avg", "inplace_broadcast": "broadcast",
    "inplace_nb_allreduce": "allreduce", "inplace_nb_broadcast": "broadcast",
    "inplace_list_0": "allreduce", "inplace_list_1": "allreduce_plus1",
    "timeout_retry": "allreduce",
}
FLAGS = ["nb_second_synchronize", "inplace_allreduce_is_input",
         "inplace_hier_local_is_input", "inplace_broadcast_is_input",
         "inplace_nb_allreduce_is_input", "inplace_nb_broadcast_is_input",
         "inplace_list_is_input", "timeout_raises", "allgather_v_mismatch",
         "allgather_mismatch", "pair_mismatch", "nag_needs_dim"]


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(100 + n)
    inp = {"x": rng.standard_normal((n, 3, 5)).astype(np.float32),
           "local_size": WORLDS[n]}
    for r in range(n):
        inp[f"ragged_{r}"] = rng.standard_normal((r % 3, 2)).astype(
            np.float32)
    return inp


def _pairs(n: int):
    self_pairs = list(range(n))
    self_pairs[1], self_pairs[2] = 2, 1
    return {r: r ^ 1 for r in range(n)}, self_pairs


def test_spmd_combine_over_subgroups(tmp_path):
    """Each P2P transfer names its peer by global rank: the subgroups'
    group rank 1 is global rank 2 or 3. Without the mapping rank 0 would
    send to global rank 1, outside its group (an error or a hang, which
    the timeout turns into a failure)."""
    x = np.random.default_rng(3).standard_normal((4, 3, 5)).astype(
        np.float32)
    np.savez(tmp_path / "inputs.npz", x=x, W=W_PAIR)
    outs = run_world("subgroup", str(tmp_path), world=4, timeout=60)
    for r in range(4):
        j = r // 2                       # the group rank; the peer is r ^ 2
        want = W_PAIR[j, j] * x[r] + W_PAIR[1 - j, j] * x[r ^ 2]
        for key in ("shift", "gather"):
            np.testing.assert_allclose(outs[r][key], want, rtol=0, atol=1e-6,
                                       err_msg=f"{key} rank {r}")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    runs = {}
    for n in WORLDS:
        d = tmp_path_factory.mktemp(f"torch_port_collectives_{n}")
        np.savez(d / "inputs.npz", **_inputs(n))
        runs[n] = run_world("collectives", str(d), world=n, timeout=120)
    return runs


def _jax_run(n: int) -> dict:
    import jax.numpy as jnp

    inp = _inputs(n)
    x = inp["x"]
    xb = jnp.asarray(x, jnp.bfloat16)
    pairs, self_pairs = _pairs(n)
    ragged = [inp[f"ragged_{r}"] for r in range(n)]
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    bf.init(devices=cpu_devices(n), local_size=WORLDS[n])
    try:
        out = {
            "layout": np.array([bf.local_size(), bf.num_machines(),
                                bf.machine_size(), bf.is_homogeneous()]),
            "hier_local_avg": bf.allreduce(x, is_hierarchical_local=True),
            "hier_local_sum": bf.allreduce(x, average=False,
                                           is_hierarchical_local=True),
            "hier_local_bf16": bf.allreduce(xb, is_hierarchical_local=True),
            "allgather": bf.allgather(x),
            "allgather_bf16": bf.allgather(xb),
            "allgather_v": [bf.allgather_v(ragged)] * n,
            "allgather_v_empty": [bf.allgather_v(
                [np.zeros((0, 3), np.float32)] * n)] * n,
            "hier": bf.hierarchical_neighbor_allreduce(x),
            "hier_weights": bf.hierarchical_neighbor_allreduce(
                x, self_weight=0.75,
                neighbor_machine_weights={0: {1: 0.25}, 1: {0: 0.25}},
                send_neighbor_machines={0: [1], 1: [0]}),
            "hier_bf16": bf.hierarchical_neighbor_allreduce(xb),
            "nag_expo2": bf.neighbor_allgather(x),
            "pair": bf.pair_gossip(x, pairs),
            "pair_w": bf.pair_gossip(x, pairs, 0.75, 0.25),
            "pair_bf16": bf.pair_gossip(xb, pairs, 0.75, 0.25),
            "pair_bf16_odd": bf.pair_gossip(xb, pairs, 0.3, 0.7),
            "pair_self": bf.pair_gossip(x, self_pairs, 0.75, 0.25),
            "allreduce": bf.allreduce(x),
            "allreduce_plus1": bf.allreduce(x + 1),
            "broadcast": bf.broadcast(x, 1),
            "nar": bf.neighbor_allreduce(x),
        }
        bad = [np.zeros((1, 5 if r == 3 else 2), np.float32)
               for r in range(n)]
        flags = {}
        for key, fn, match in (
                ("allgather_v_mismatch", lambda: bf.allgather_v(bad),
                 "trailing shape"),
                ("pair_mismatch", lambda: bf.pair_gossip(
                    x, {r: (r + 1) % n for r in range(n)}), "mutual")):
            with pytest.raises(ValueError, match=match):
                fn()
            flags[key] = 1
        bf.set_topology(topology_util.StarGraph(n))
        out["nag_star"] = bf.neighbor_allgather(x)
        out = {k: [f32(a) for a in v] if isinstance(v, list) else f32(v)
               for k, v in out.items()}
        return dict(out, flags=flags)
    finally:
        bf.shutdown()


@pytest.fixture(scope="module")
def jax_runs():
    return {n: _jax_run(n) for n in WORLDS}


@pytest.mark.parametrize("n", list(WORLDS))
def test_port_layout_matches_jax(n, port_runs, jax_runs):
    for r in range(n):
        local_size, local_rank, *rest = port_runs[n][r]["layout"]
        assert local_rank == r % WORLDS[n]
        np.testing.assert_array_equal([local_size, *rest],
                                      jax_runs[n]["layout"])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", list(WORLDS))
def test_port_collective_matches_jax(n, case, port_runs, jax_runs):
    want_all = jax_runs[n][CASES[case]]
    for r in range(n):
        got, want = port_runs[n][r][case], want_all[r]
        assert got.shape == want.shape, (case, r, got.shape, want.shape)
        if case in EXACT:
            atol = 0.0
        elif case in BF16:
            atol = 2.0 ** -8 * float(np.abs(want).max())
        else:
            atol = 1e-6
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=f"{case} rank {r}")


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("n", list(WORLDS))
def test_port_collective_contract(n, flag, port_runs, jax_runs):
    """The handle, in-place and error contracts held on every rank; the
    errors JAX raises on the same inputs too."""
    assert [int(o[f"flag:{flag}"]) for o in port_runs[n]] == [1] * n
    if flag in jax_runs[n]["flags"]:
        assert jax_runs[n]["flags"][flag] == 1


def test_port_runtime_answers():
    """The state surface that needs no peers, at world 1 on the CPU: a
    layout that does not divide raises on every hierarchical op."""
    bft.init(device="cpu", local_size=2)
    try:
        assert not bft.is_homogeneous()
        assert bft.num_machines() == bft.machine_size() == 0
        assert bft.mpi_threads_supported() is True
        assert bft.nccl_built() == torch.distributed.is_nccl_available()
        assert bft.get_skip_negotiate_stage() is False
        bft.set_skip_negotiate_stage(True)
        assert bft.get_skip_negotiate_stage() is True
        x = torch.ones(2, 3)
        hier_opt = bft.DistributedHierarchicalNeighborAllreduceOptimizer
        for fn in (lambda: bft.hierarchical_neighbor_allreduce(x),
                   lambda: bft.allreduce(x, is_hierarchical_local=True),
                   lambda: hier_opt(
                       torch.optim.SGD([torch.nn.Parameter(x)], lr=0.1),
                       torch.nn.Module(), lambda m, b: 0)):
            with pytest.raises(RuntimeError, match="homogeneous"):
                fn()
        with pytest.raises(ValueError, match="already-synchronized"):
            bft.synchronize(12345)
    finally:
        bft.shutdown()
    assert not torch.distributed.is_initialized()
