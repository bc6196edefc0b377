"""Port vs JAX: pipeline parallelism (the GPipe schedule over stages).

The port runs as four gloo processes, one stage each (or two pipelines of
two stages, ranks {0, 1} and {2, 3}); the JAX package runs the same flax
weights and tokens on its CPU mesh (``pp_mesh``). The cases follow
``tests/test_pipeline_parallel.py`` (8 layers, heads 2, d_model 16, d_ff
32, vocab 32, batch 4 x 8, f32):

  * ``pp_apply`` at (stages, microbatches) = (4, 2) and (2, 4) against
    JAX's ``pp_apply`` and the dense oracle (1e-4), on every rank;
  * ``pp_forward_fn`` on a placed stage, called twice: bit-equal, and
    equal to JAX;
  * ``pp_loss_fn`` and the fused-loss schedule (``_pp_fused_loss``) at 4
    stages: the losses against JAX's (1e-5) and each other (rtol 1e-5),
    every rank's gradient of its stage and of ``rest`` against
    ``jax.grad`` of JAX's ``pp_loss_fn`` (1e-5 of the largest; ``rest``'s
    gradient is the full one on every rank, so n times or 1/n of it
    misses);
  * the stage-stack layout and the bad-count errors ("multiple of",
    "microbatch");
  * the training curve of ``pp_train_step_fn`` (2 stages, 2 layers, 8
    steps, torch Adam 1e-2), plain and fused, against JAX's with optax
    Adam 1e-2 (rtol and atol 2e-4, as JAX's test), and the trained logits
    against JAX's (2e-3).

At world 1, in this process: ``chip_smoke.py``'s virtual pipeline of 4
stages (the port's tick schedule with the handoff a list roll) against the
dense model, with its planted fault.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bluefog_tpu.models import TransformerLM as JaxLM
from bluefog_tpu.parallel import pipeline as jax_pp
from bluefog_tpu_torch.parallel import pipeline as port_pp
from bluefog_tpu_torch.utils import params_from_jax
from conftest import cpu_devices
from _torch_port_child import run_world
from test_torch_port_slice import _flat, jax_to_dict, jax_tree_np

N = 4
CFG = dict(vocab=32, layers=8, heads=2, d_model=16, d_ff=32)
B, S = 4, 8
STEPS = 8


def _jax_lm(layers):
    return JaxLM(vocab_size=CFG["vocab"], num_layers=layers,
                 num_heads=CFG["heads"], d_model=CFG["d_model"],
                 d_ff=CFG["d_ff"])


def _cfg(layers):
    return np.array([CFG["vocab"], layers, CFG["heads"], CFG["d_model"],
                     CFG["d_ff"]])


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG["vocab"], (B, S)).astype(np.int32)
    train_tokens = rng.integers(0, CFG["vocab"], (B, S)).astype(np.int32)
    params = jax_tree_np(jax.jit(_jax_lm(8).init)(
        jax.random.PRNGKey(0), tokens)["params"])
    train_params = jax_tree_np(jax.jit(_jax_lm(2).init)(
        jax.random.PRNGKey(0), train_tokens)["params"])
    return (tokens, np.roll(tokens, -1, axis=1), params, train_tokens,
            np.roll(train_tokens, -1, axis=1), train_params)


@pytest.fixture(scope="module")
def port_run(setup, tmp_path_factory):
    tokens, targets, params, ttok, ttgt, tparams = setup
    d = tmp_path_factory.mktemp("torch_port_pipeline")
    np.savez(d / "inputs.npz", tokens=tokens, targets=targets, cfg=_cfg(8),
             train_tokens=ttok, train_targets=ttgt, steps=STEPS,
             **{"train:cfg": _cfg(2)},
             **{f"p:{k}": v for k, v in _flat(jax_to_dict(params)).items()},
             **{f"train:p:{k}": v for k, v in
                _flat(jax_to_dict(tparams)).items()})
    return run_world("pipeline", str(d), world=N, timeout=240)


def _port_stacked(tree, n_stages):
    """A flax gradient or parameter tree in the port's names and layout,
    stage-stacked: ``(stacked, rest)`` as numpy."""
    stacked, rest = port_pp.pp_stack_params(params_from_jax(tree), n_stages)
    return ({k: v.numpy() for k, v in stacked.items()},
            {k: v.numpy() for k, v in rest.items()})


@pytest.fixture(scope="module")
def jax_run(setup):
    tokens, targets, params, ttok, ttgt, tparams = setup
    model = _jax_lm(8)
    out = {"oracle": np.asarray(model.apply({"params": params}, tokens))}
    for n_stages, n_micro in ((4, 2), (2, 4)):
        mesh = jax_pp.pp_mesh(n_stages, cpu_devices(n_stages))
        out[f"apply_{n_stages}_{n_micro}"] = np.asarray(jax_pp.pp_apply(
            model, params, tokens, mesh, n_micro=n_micro))
    mesh = jax_pp.pp_mesh(N, cpu_devices(N))
    stacked, rest = jax_pp.pp_stack_params(params, N)
    batch = (jnp.asarray(tokens), jnp.asarray(targets))
    for key, loss_fn in (("plain", jax_pp.pp_loss_fn(model, mesh, 2)),
                         ("fused", jax_pp._pp_fused_loss(model, mesh, N, 2))):
        loss, (gs, gr) = jax.jit(jax.value_and_grad(
            lambda s, r, fn=loss_fn: fn(s, r, batch), argnums=(0, 1)))(
                stacked, rest)
        out[f"{key}:loss"] = float(loss)
    # the gradients unstacked to one flax tree, then in the port's layout
    per = CFG["layers"] // N
    tree = {k: v for k, v in jax_tree_np(gr).items()}
    for s in range(N):
        for j in range(per):
            tree[f"block_{s * per + j}"] = jax.tree_util.tree_map(
                lambda x, s=s, j=j: np.asarray(x[s, j]), gs)
    out["grads"] = _port_stacked(tree, N)

    two = _jax_lm(2)
    mesh2 = jax_pp.pp_mesh(2, cpu_devices(2))
    adam = optax.adam(1e-2)
    tbatch = (jnp.asarray(ttok), jnp.asarray(ttgt))
    for key, fused in (("plain", False), ("fused", True)):
        st, re, opt = jax_pp.pp_train_init(two, mesh2, tparams, adam)
        step = jax_pp.pp_train_step_fn(two, mesh2, adam, n_micro=2,
                                       fused_loss=fused)
        losses = []
        for _ in range(STEPS):
            st, re, opt, loss = step(st, re, opt, tbatch)
            losses.append(float(loss))
        out[f"curve_{key}"] = np.array(losses)
        out[f"curve_{key}_logits"] = np.asarray(jax_pp.pp_forward_fn(
            two, mesh2, n_micro=2)(st, re, tbatch[0]))
    return out


def _nerr(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("n_stages,n_micro", [(4, 2), (2, 4)])
def test_pp_apply_matches_jax(n_stages, n_micro, port_run, jax_run):
    want = jax_run[f"apply_{n_stages}_{n_micro}"]
    np.testing.assert_allclose(want, jax_run["oracle"], atol=1e-4)
    for rank in range(N):
        got = port_run[rank][f"apply_{n_stages}_{n_micro}"]
        np.testing.assert_allclose(got, want, atol=1e-4,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(got, jax_run["oracle"], atol=1e-4)


def test_pp_forward_fn_reuses_placed_params(port_run, jax_run):
    for rank in range(N):
        got = port_run[rank]
        np.testing.assert_array_equal(got["fwd_1"], got["fwd_2"])
        np.testing.assert_allclose(got["fwd_1"], jax_run["oracle"],
                                   atol=1e-4)


@pytest.mark.parametrize("key", ["plain", "fused"])
def test_pp_loss_and_grads_match_jax(key, port_run, jax_run):
    """The loss on every rank, each rank's stage gradient (its row of
    JAX's stacked gradient) and the full ``rest`` gradient."""
    gs, gr = jax_run["grads"]
    for rank in range(N):
        got = port_run[rank]
        np.testing.assert_allclose(got[f"{key}:loss"], jax_run[f"{key}:loss"],
                                   atol=1e-5, rtol=1e-5)
        for k, want in gs.items():
            g = got[f"{key}:g:{k}"]
            assert g.shape == (1,) + want.shape[1:], k
            assert _nerr(g[0], want[rank]) <= 1e-5, (rank, k)
        for k, want in gr.items():
            g = got[f"{key}:g:{k}"]
            assert _nerr(g, want) <= 1e-5, (rank, k)
            assert _nerr(g * N, want) > 1e-2 and _nerr(g / N, want) > 1e-2


def test_pp_fused_loss_matches_plain(port_run):
    for rank in range(N):
        got = port_run[rank]
        np.testing.assert_allclose(got["fused:loss"], got["plain:loss"],
                                   rtol=1e-5)


def test_pp_stage_stack_layout_and_bad_counts(setup, port_run):
    _, _, params, *_ = setup
    stacked, rest = port_pp.pp_stack_params(
        params_from_jax(params), 2)
    qkv = stacked["qkv.weight"]
    # [n_stages, layers_per_stage, 3*d_model, d_model], stage 1 = blocks 4-7
    assert tuple(qkv.shape) == (2, 4, 48, 16)
    np.testing.assert_array_equal(
        qkv[1, 0].numpy(), params["block_4"]["qkv"]["kernel"].T)
    assert set(rest) == {"embed.weight", "final_norm.scale",
                         "lm_head.weight"}
    with pytest.raises(ValueError, match="multiple of"):
        port_pp.pp_stack_params(params_from_jax(params), 3)
    for rank in range(N):
        assert port_run[rank]["flag:bad_micro"] == 1
        assert port_run[rank]["flag:bad_layers"] == 1


@pytest.mark.parametrize("key", ["plain", "fused"])
def test_pp_training_matches_jax_loss_curve(key, port_run, jax_run):
    """Two 2-stage pipelines train the same model (ranks {0, 1}, {2, 3}):
    each rank's curve against JAX's ``pp_train_step_fn`` and falling; the
    trained pipeline's logits against JAX's."""
    want = jax_run[f"curve_{key}"]
    for rank in range(N):
        got = port_run[rank][f"curve_{key}"]
        assert got[-1] < got[0]
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(port_run[rank][f"curve_{key}_logits"],
                                   jax_run[f"curve_{key}_logits"],
                                   atol=2e-3, rtol=2e-3)


def test_chip_smoke_virtual_pipeline_matches_dense():
    """``chip_smoke.py``'s virtual pipeline of four stages on the CPU in
    f32 (one layer each, four microbatches of one sequence): logits, every
    stage's and ``rest``'s gradient (plain and fused) within 1e-5 of the
    dense model's, both losses within 1e-6, and the handoff rolled the
    wrong way far beyond."""
    import bluefog_tpu_torch as bft
    import chip_smoke
    from bluefog_tpu_torch.parallel import flash as fl

    dense = bft.models.TransformerLM(
        vocab_size=CFG["vocab"], num_layers=N, num_heads=CFG["heads"],
        d_model=CFG["d_model"], d_ff=CFG["d_ff"], device="cpu", seed=2)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, CFG["vocab"], (N, S)))
    res = chip_smoke.virtual_pp(bft, fl, torch, dense,
                                (toks, toks.roll(-1, dims=1)), n=N)
    e = res["errors"]
    assert e["logits"] <= 1e-5 and e["grad"] <= 1e-5 and \
        e["fused_grad"] <= 1e-5, e
    assert e["plain_loss"] <= 1e-6 and e["fused_loss"] <= 1e-6, e
    for fault in chip_smoke.PP_FAULTS:
        assert res["planted"][fault] > 0.1, fault
