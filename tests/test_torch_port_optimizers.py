"""Port vs JAX: the ZeRO-1 and hierarchical optimizers, and
``broadcast_optimizer_state``.

The port runs as four gloo processes (2 machines of 2 ranks); the JAX
package runs the same cases on its 4-device CPU mesh with
``local_size=2``. Each case has its JAX counterpart in
``tests/test_optimizers.py``:

  * ZeRO-1 around Adam(0.1) on the two-leaf padding case (:268-290; total
    7 at world 4: shards of 2, one pad), 5 steps: against the port's
    gradient allreduce around the same Adam to 1e-6, and against JAX's
    parameters to 1e-5 and losses to 1e-5 relative (optax forms Adam's
    bias corrections in f32, torch in double);
  * the shard really sharded (:292-307): the optimizer state holds
    ``ceil(13 / 4)`` elements, and the parameters stay replicated;
  * ``num_steps_per_communication=2`` rejected (:310-313);
  * the hierarchical optimizer's consensus (:129-149): one step of SGD on a
    zero gradient is the machine mean, then the 2-machine combine, which
    is the global mean;
  * the small flash ``TransformerLM`` (L=2, d=64, f32, from the flax init)
    under both optimizers, 3 Adam steps: losses and parameters to 1e-5.
    Adam's eps is ``ADAM_EPS`` = 1e-6 on both sides: Adam divides each
    gradient element by its own root mean square, so near a zero gradient
    it multiplies the f32 rounding of the two backward passes by up to
    lr / eps. At the default 1e-8 one element in 16,384 of
    ``block_0/down`` (a mean gradient of -4.2e-9 at step 1) moved 7.7e-5;
    at 1e-6 the largest difference is 3.7e-6;
  * ``broadcast_optimizer_state`` from rank 1 against JAX's broadcast of
    the stacked optax state: Adam's moments and step on every rank,
    allocated on the rank that had not stepped.

World-1 checks in this process: the constructor's refusals, the
hierarchical plan's argument check, and ZeRO-1 on a tree that mixes bf16
and f32 leaves against JAX's (both update the promoted f32 flat buffer and
round the bf16 leaf back).
"""

from functools import partial

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu.models.transformer import TransformerLM
from bluefog_tpu.parallel.flash import flash_attention
from conftest import cpu_devices
from _torch_port_child import run_world
from test_torch_port_slice import _flat, _port_name, jax_to_dict

N, L = 4, 2
CFG = dict(vocab=128, layers=2, heads=4, d_model=64, d_ff=256)
B, S, STEPS = 2, 64, 3
LM_KINDS = ("lm_zero1", "lm_hier")
ADAM_EPS = 1e-6


def multi_leaf_loss(p, b):
    import jax.numpy as jnp

    return 0.5 * jnp.sum((p["w"] - b) ** 2) + \
        0.5 * jnp.sum((p["b"] - 1.0) ** 2)


@pytest.fixture(scope="module")
def setup():
    import jax

    model = TransformerLM(
        vocab_size=CFG["vocab"], num_layers=CFG["layers"],
        num_heads=CFG["heads"], d_model=CFG["d_model"], d_ff=CFG["d_ff"],
        attn_fn=partial(flash_attention, causal=True, interpret=True))
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((1, S), np.int32))["params"]
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, CFG["vocab"], (N, B, S)).astype(np.int32)
    x0 = rng.standard_normal((N, 4)).astype(np.float32)
    return model, params, tokens, np.roll(tokens, -1, axis=2), x0


@pytest.fixture(scope="module")
def port_run(setup, tmp_path_factory):
    _, params, tokens, targets, x0 = setup
    d = tmp_path_factory.mktemp("torch_port_optimizers")
    np.savez(d / "inputs.npz", tokens=tokens, targets=targets, steps=STEPS,
             x0=x0, local_size=L, adam_eps=ADAM_EPS, **CFG,
             **{f"p:{k}": v for k, v in _flat(jax_to_dict(params)).items()})
    return run_world("optimizers", str(d), world=N, timeout=240)


@pytest.fixture(scope="module")
def jax_run(setup):
    import jax
    import jax.numpy as jnp
    import optax

    model, params, tokens, targets, x0 = setup

    def lm_loss(p, batch):
        logits = model.apply({"params": p}, batch[0])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch[1]).mean()

    np_tree = partial(jax.tree_util.tree_map, np.asarray)
    bf.init(devices=cpu_devices(N), local_size=L)
    try:
        out = {}
        zero1 = bf.DistributedShardedAllreduceOptimizer(optax.adam(0.1),
                                                        multi_leaf_loss)
        state = zero1.init({"w": jnp.zeros(4), "b": jnp.full(3, 2.0)})
        t = jnp.arange(N, dtype=jnp.float32)[:, None] * jnp.ones((N, 4))
        losses = []
        for _ in range(5):
            state, m = zero1.step(state, t)
            losses.append(np.asarray(m["loss"]))
        out["zero1_losses"] = np.stack(losses, axis=1)
        out["zero1_w"] = np.asarray(state.params["w"])
        out["zero1_b"] = np.asarray(state.params["b"])
        out["zero1_shard"] = {l.shape[1:] for l in jax.tree_util.tree_leaves(
            state.opt_state) if l.ndim >= 2}

        state = zero1.init({"w": jnp.zeros(10), "b": jnp.zeros(3)})
        state, _ = zero1.step(state, jnp.arange(N, dtype=jnp.float32)[:, None]
                              * jnp.ones((N, 10)))
        out["shard13_w"] = np.asarray(state.params["w"])
        out["shard13_shard"] = {
            l.shape[1:] for l in jax.tree_util.tree_leaves(state.opt_state)
            if l.ndim >= 2}
        with pytest.raises(ValueError, match="num_steps_per_communication"):
            bf.DistributedShardedAllreduceOptimizer(
                optax.sgd(0.1), multi_leaf_loss,
                num_steps_per_communication=2)

        hier = bf.DistributedHierarchicalNeighborAllreduceOptimizer(
            optax.sgd(0.1), lambda p, b: 0.0 * jnp.sum(p["w"]))
        st0 = hier.init({"w": x0[0]})
        state = bf.TrainState(
            params=jax.device_put({"w": x0}, jax.sharding.NamedSharding(
                bf.machine_mesh(),
                jax.sharding.PartitionSpec(("machine", "local")))),
            opt_state=st0.opt_state, model_state=None)
        state, _ = hier.step(state, jnp.zeros((N, 1)))
        out["hier_consensus"] = np.asarray(state.params["w"])

        for key, cls in (
                ("lm_zero1", bf.DistributedShardedAllreduceOptimizer),
                ("lm_hier",
                 bf.DistributedHierarchicalNeighborAllreduceOptimizer)):
            opt = cls(optax.adam(1e-3, eps=ADAM_EPS), lm_loss)
            state = opt.init(params)
            losses = []
            for _ in range(STEPS):
                state, m = opt.step(state, (tokens, targets))
                losses.append(np.asarray(m["loss"]))
            out[key] = (_flat(jax_to_dict(np_tree(state.params))),
                        np.stack(losses, axis=1))

        adam = optax.adam(0.1)
        states = []
        for r in range(N):
            p = jnp.ones(3) * r
            s = adam.init(p)
            if r != 3:
                _, s = adam.update((r + 1.0) * jnp.arange(3.0), s, p)
            states.append(s)
        stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *states)
        out["bos"] = np_tree(bf.broadcast_optimizer_state(stacked,
                                                          root_rank=1))[0]
        return out
    finally:
        bf.shutdown()


def test_port_zero1_matches_gradient_allreduce(port_run):
    """JAX's own check (``tests/test_optimizers.py:268-290``) on the port:
    ZeRO-1 takes the steps of the gradient allreduce around the same
    torch Adam."""
    for r in range(N):
        for k in ("losses", "w", "b"):
            np.testing.assert_allclose(port_run[r][f"zero1_{k}"],
                                       port_run[r][f"zero1_ref_{k}"], rtol=0,
                                       atol=1e-6, err_msg=f"rank {r} {k}")


def test_port_zero1_matches_jax(port_run, jax_run):
    """Against JAX's ZeRO-1 around ``optax.adam``. At lr 0.1 the two Adams
    part by ~1e-5 of the loss over 5 steps: optax forms its bias
    corrections ``1 - b**t`` in f32 (``1 - f32(0.999)`` is 1.3e-5 off
    0.001), torch in double; so the losses are held to 1e-5 relative."""
    for r in range(N):
        port = port_run[r]
        np.testing.assert_allclose(port["zero1_losses"],
                                   jax_run["zero1_losses"][r], rtol=1e-5,
                                   atol=0)
        for k in ("w", "b"):
            np.testing.assert_allclose(port[f"zero1_{k}"],
                                       jax_run[f"zero1_{k}"][r], rtol=0,
                                       atol=1e-5, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("case", ["zero1", "shard13"])
def test_port_zero1_state_is_sharded(case, port_run, jax_run):
    """Each rank's optimizer state holds ``ceil(total / n)`` elements (the
    shard JAX keeps) and the parameters stay replicated."""
    (shard,) = jax_run[f"{case}_shard"]
    total = {"zero1": 7, "shard13": 13}[case]
    assert shard == (-(-total // N),)
    for r in range(N):
        assert list(port_run[r][f"{case}_state_sizes"]) == [shard[0]] * 2
        np.testing.assert_array_equal(port_run[r][f"{case}_w"],
                                      port_run[0][f"{case}_w"])
    np.testing.assert_allclose(port_run[0]["shard13_w"],
                               jax_run["shard13_w"][0], rtol=0, atol=1e-6)


def test_port_zero1_rejects_local_steps(port_run):
    assert [int(o["flag:zero1_local_steps"]) for o in port_run] == [1] * N


def test_port_hierarchical_consensus(port_run, jax_run, setup):
    x0 = setup[-1]
    want = np.mean(x0.astype(np.float64), axis=0)
    for r in range(N):
        np.testing.assert_allclose(port_run[r]["hier_consensus"],
                                   jax_run["hier_consensus"][r], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(port_run[r]["hier_consensus"], want,
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("rank", range(N))
@pytest.mark.parametrize("kind", LM_KINDS)
def test_port_lm_optimizer_matches_jax(kind, rank, port_run, jax_run):
    jax_params, jax_losses = jax_run[kind]
    port = port_run[rank]
    np.testing.assert_allclose(port[f"{kind}:losses"], jax_losses[rank],
                               rtol=0, atol=1e-5)
    for key, want in jax_params.items():
        got = port[f"{kind}:sd:{_port_name(key)}"]
        if key.endswith("kernel"):
            got = got.T
        np.testing.assert_allclose(got, want[rank], rtol=0, atol=1e-5,
                                   err_msg=f"{kind} rank {rank} {key}")


def test_port_lm_ranks_differ(port_run):
    """ZeRO-1 keeps the ranks' parameters equal; the hierarchical combine
    of 2 machines at Expo-2 also ends equal after one step, so its ranks'
    losses must differ (each rank has its own batch)."""
    zero = [o["lm_zero1:sd:lm_head.weight"] for o in port_run]
    for z in zero[1:]:
        np.testing.assert_array_equal(z, zero[0])
    assert len({float(o["lm_hier:losses"][0]) for o in port_run}) == N


def test_port_broadcast_optimizer_state(port_run, jax_run):
    mu, nu, count = (jax_run["bos"].mu, jax_run["bos"].nu,
                     jax_run["bos"].count)
    for r in range(N):
        port = port_run[r]
        np.testing.assert_allclose(port["bos_exp_avg"], mu[r], rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(port["bos_exp_avg_sq"], nu[r], rtol=0,
                                   atol=1e-7)
        assert float(port["bos_step"]) == float(count[r]) == 1.0
        assert int(port["flag:bos_step_on_cpu"]) == 1
        assert int(port["flag:bos_empty_root"]) == 1


@pytest.fixture
def world1():
    bft.init(device="cpu")
    try:
        yield bft
    finally:
        bft.shutdown()


def _two_leaf(dtype_w=torch.float32):
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.zeros(4, dtype=dtype_w))
    model.b = torch.nn.Parameter(torch.full((3,), 2.0))
    return model


def _torch_loss(model, t):
    return 0.5 * ((model.w.float() - t) ** 2).sum() + \
        0.5 * ((model.b - 1.0) ** 2).sum()


def test_port_zero1_refusals(world1):
    model = _two_leaf()
    two_groups = torch.optim.Adam([{"params": [model.w]},
                                   {"params": [model.b], "lr": 0.5}])
    with pytest.raises(ValueError, match="one param group"):
        world1.DistributedShardedAllreduceOptimizer(two_groups, model,
                                                    _torch_loss)
    stepped = torch.optim.Adam(model.parameters(), lr=0.1)
    _torch_loss(model, torch.ones(4)).backward()
    stepped.step()
    with pytest.raises(ValueError, match="no state"):
        world1.DistributedShardedAllreduceOptimizer(stepped, model,
                                                    _torch_loss)


def test_port_hierarchical_plan_checks(world1):
    model = _two_leaf()
    opt = world1.DistributedHierarchicalNeighborAllreduceOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), model, _torch_loss)
    opt.neighbor_machine_weights = {0: {}}
    with pytest.raises(ValueError, match="requires send_neighbor_machines"):
        opt.step(torch.ones(4))


def test_port_zero1_mixed_dtypes_match_jax(world1):
    """A bf16 leaf beside an f32 one: both sides update the f32 flat
    buffer and round the bf16 leaf back, 3 Adam steps."""
    import jax.numpy as jnp
    import optax

    model = _two_leaf(torch.bfloat16)
    opt = world1.DistributedShardedAllreduceOptimizer(
        torch.optim.Adam(model.parameters(), lr=0.1), model, _torch_loss)
    target = torch.arange(4.0) / 3.0
    port = [float(opt.step(target)["loss"]) for _ in range(3)]
    assert model.w.dtype == torch.bfloat16

    def loss(p, t):
        return 0.5 * jnp.sum((p["w"].astype(jnp.float32) - t) ** 2) + \
            0.5 * jnp.sum((p["b"] - 1.0) ** 2)

    world1.shutdown()
    bf.init(devices=cpu_devices(1))
    try:
        zero1 = bf.DistributedShardedAllreduceOptimizer(optax.adam(0.1), loss)
        state = zero1.init({"w": jnp.zeros(4, jnp.bfloat16),
                            "b": jnp.full(3, 2.0)})
        want = []
        for _ in range(3):
            state, m = zero1.step(state, target.numpy()[None])
            want.append(float(m["loss"][0]))
        w = np.asarray(state.params["w"][0].astype(jnp.float32))
        b = np.asarray(state.params["b"][0])
    finally:
        bf.shutdown()
    np.testing.assert_allclose(port, want, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(model.w.detach().float().numpy(), w)
    np.testing.assert_allclose(model.b.detach().numpy(), b, rtol=0,
                               atol=1e-5)
