"""Port vs JAX: the whole slice — three decentralized training steps.

``DistributedNeighborAllreduceOptimizer`` around Adam (lr 1e-3) trains the
tiny flash ``TransformerLM`` (L=2, d=64, H=4, V=128, S=64, f32) at world 4:
the port as four gloo processes, each with its own numpy batch; the JAX
package on its 4-device CPU mesh from the same flax init, with the Pallas
flash kernel in interpret mode inside the fused step. After three steps
(local step, then the Expo-2 combine of the parameters) every rank's
parameters must agree to 1e-4 and the losses to 1e-5: Adam normalises each
update to ~lr, so f32 gradient differences of ~1e-7 stay well inside it.
"""

from functools import partial

import numpy as np
import pytest

import bluefog_tpu as bf
from bluefog_tpu.models.transformer import TransformerLM
from bluefog_tpu.parallel.flash import flash_attention
from conftest import cpu_devices
from _torch_port_child import run_world

N = 4
CFG = dict(vocab=128, layers=2, heads=4, d_model=64, d_ff=256)
B, S, STEPS = 2, 64, 3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v, np.float32)})
    return out


@pytest.fixture(scope="module")
def setup():
    import jax

    model = TransformerLM(
        vocab_size=CFG["vocab"], num_layers=CFG["layers"],
        num_heads=CFG["heads"], d_model=CFG["d_model"], d_ff=CFG["d_ff"],
        attn_fn=partial(flash_attention, causal=True, interpret=True))
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((1, S), np.int32))["params"]
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, CFG["vocab"], (N, B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=2)
    return model, params, tokens, targets


@pytest.fixture(scope="module")
def port_run(setup, tmp_path_factory):
    _, params, tokens, targets = setup
    d = tmp_path_factory.mktemp("torch_port_slice")
    np.savez(d / "inputs.npz", tokens=tokens, targets=targets, steps=STEPS,
             **CFG, **{f"p:{k}": v for k, v in
                       _flat(jax_to_dict(params)).items()})
    return run_world("slice", str(d), world=N)


def jax_to_dict(tree):
    return {k: jax_to_dict(v) if hasattr(v, "items") else v
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_run(setup):
    import optax

    model, params, tokens, targets = setup

    def loss_fn(p, batch):
        toks, tgts = batch
        logits = model.apply({"params": p}, toks)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tgts).mean()

    bf.init(devices=cpu_devices(N))
    try:
        opt = bf.DistributedNeighborAllreduceOptimizer(optax.adam(1e-3),
                                                       loss_fn)
        state = opt.init(params)
        losses = []
        for _ in range(STEPS):
            state, metrics = opt.step(state, (tokens, targets))
            losses.append(np.asarray(metrics["loss"]))
        return (_flat(jax_to_dict(jax_tree_np(state.params))),
                np.stack(losses, axis=1))
    finally:
        bf.shutdown()


def jax_tree_np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _port_name(flax_key: str) -> str:
    *mods, leaf = flax_key.split("/")
    return ".".join(mods) + {"kernel": ".weight", "embedding": ".weight",
                             "scale": ".scale"}[leaf]


@pytest.mark.parametrize("rank", range(N))
def test_port_slice_matches_jax(rank, port_run, jax_run):
    jax_params, jax_losses = jax_run
    port = port_run[rank]
    np.testing.assert_allclose(port["losses"], jax_losses[rank], rtol=0,
                               atol=1e-5)
    for key, want in jax_params.items():
        got = port[f"sd:{_port_name(key)}"]
        if key.endswith("kernel"):
            got = got.T
        np.testing.assert_allclose(got, want[rank], rtol=0, atol=1e-4,
                                   err_msg=f"rank {rank} param {key}")


def test_port_slice_ranks_differ_then_mix(port_run):
    """The per-rank batches differ, so the ranks' parameters differ after
    the combine — the test is not passing on four copies of one run."""
    a, b = port_run[0], port_run[1]
    assert not np.allclose(a["sd:lm_head.weight"], b["sd:lm_head.weight"])
