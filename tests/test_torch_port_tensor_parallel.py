"""Port vs JAX: tensor parallelism (Megatron over a model group).

The port runs as four gloo processes, each holding its slices
(``tp_shard_params``); the JAX package runs the same flax weights and
tokens on its CPU mesh (``tp_mesh``), where XLA's partitioner inserts the
all-reduces. The cases follow ``tests/test_tensor_parallel.py``
(heads 4, d_model 32, d_ff 64, vocab 64, 2 layers, batch 4 x 16, f32):

  * ``main``: the world as one model group of 4, against JAX's
    ``tp_apply`` on ``tp_mesh(2, 4)`` and the dense oracle (logits, 1e-4),
    the loss of ``tp_loss_fn`` (1e-5) and every rank's gradient of every
    slice against ``jax.grad(tp_loss_fn)`` sliced to that rank (1e-5 of
    the largest: a gradient summed n times, or a quarter of one, misses);
  * the shards: 1/4 slices (``qkv`` the q, k and v rows of the rank's own
    heads), norms whole;
  * ``ff62``: d_ff 62 does not divide 4, so ``up``/``down`` stay whole and
    the rest shards; logits, loss and gradients as above;
  * ``dm``: 2 x 2 (data x model), against JAX on ``tp_mesh(2, 2)``: each
    rank runs its data shard of 2 sequences, and the gradients are summed
    over the data group inside the loss's backward;
  * a model sharded over 4 ranks refuses a group of 2.

At world 1, in this process: ``chip_smoke.py``'s virtual TP group of 4
(the port's step functions over a list of four ranks' slices) against the
dense model, with its planted faults.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bluefog_tpu_torch as bft
from bluefog_tpu import parallel as bfp
from bluefog_tpu.models import TransformerLM as JaxLM
from bluefog_tpu_torch.parallel import tensor as port_tp
from bluefog_tpu_torch.utils import params_from_jax
from conftest import cpu_devices
from _torch_port_child import run_world
from test_torch_port_slice import _flat, jax_to_dict, jax_tree_np

N = 4
CFG = dict(heads=4, d_model=32, d_ff=64, vocab=64, layers=2)
B, S = 4, 16
CASES = ("main", "ff62", "dm")


def _cfg(d_ff):
    return np.array([CFG["vocab"], CFG["layers"], CFG["heads"],
                     CFG["d_model"], d_ff])


def _jax_lm(d_ff):
    return JaxLM(vocab_size=CFG["vocab"], num_layers=CFG["layers"],
                 num_heads=CFG["heads"], d_model=CFG["d_model"], d_ff=d_ff)


def _port_lm(d_ff):
    return bft.models.TransformerLM(
        vocab_size=CFG["vocab"], num_layers=CFG["layers"],
        num_heads=CFG["heads"], d_model=CFG["d_model"], d_ff=d_ff,
        device="cpu")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG["vocab"], (B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    params = {}
    for d_ff in (64, 62):
        params[d_ff] = jax_tree_np(jax.jit(_jax_lm(d_ff).init)(
            jax.random.PRNGKey(0), tokens)["params"])
    return tokens, targets, params


@pytest.fixture(scope="module")
def port_run(setup, tmp_path_factory):
    tokens, targets, params = setup
    d = tmp_path_factory.mktemp("torch_port_tensor")
    np.savez(d / "inputs.npz", tokens=tokens, targets=targets,
             cfg=_cfg(64), **{"ff62:cfg": _cfg(62)},
             **{f"p:{k}": v for k, v in _flat(jax_to_dict(params[64]))
                .items()},
             **{f"ff62:p:{k}": v for k, v in _flat(jax_to_dict(params[62]))
                .items()})
    return run_world("tensor", str(d), world=N, timeout=240)


@pytest.fixture(scope="module")
def jax_run(setup):
    """JAX's logits, loss and gradients per case, the gradients in the
    port's names and layout (``params_from_jax`` of the gradient tree)."""
    tokens, targets, params = setup
    out = {}
    for case, d_ff, shape in (("main", 64, (2, 4)), ("ff62", 62, (2, 4)),
                              ("dm", 64, (2, 2))):
        model = _jax_lm(d_ff)
        mesh = bfp.tp_mesh(*shape, cpu_devices(shape[0] * shape[1]))
        tp_params = bfp.tp_shard_params(params[d_ff], mesh)
        loss_fn = bfp.tp_loss_fn(model, mesh)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            tp_params, (jnp.asarray(tokens), jnp.asarray(targets)))
        out[case] = {
            "logits": np.asarray(bfp.tp_apply(model, tp_params, tokens,
                                              mesh)),
            "oracle": np.asarray(model.apply({"params": params[d_ff]},
                                             tokens)),
            "loss": float(loss),
            "grads": {k: v.numpy() for k, v in params_from_jax(
                jax_tree_np(grads)).items()},
        }
    return out


def _model_index(case, rank):
    return (rank % 2, 2) if case == "dm" else (rank, N)


def _rows(case, rank):
    return slice(2 * (rank // 2), 2 * (rank // 2) + 2) if case == "dm" \
        else slice(None)


def _layout(case):
    n = 2 if case == "dm" else N
    return port_tp.tp_layout(_port_lm(62 if case == "ff62" else 64), n)


def _nerr(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("case", CASES)
def test_tp_logits_match_jax_and_dense(case, port_run, jax_run):
    want = jax_run[case]
    np.testing.assert_allclose(want["logits"], want["oracle"], atol=1e-4)
    for rank in range(N):
        got = port_run[rank][f"{case}:logits"]
        rows = _rows(case, rank)
        np.testing.assert_allclose(got, want["logits"][rows], atol=1e-4,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(got, want["oracle"][rows], atol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_tp_grads_match_jax_sliced(case, port_run, jax_run):
    """Every rank's gradient of every parameter against JAX's gradient
    sliced to that rank (the whole of it for a replicated parameter), and
    the loss; a gradient n times too large or too small would miss."""
    want = jax_run[case]
    layout = _layout(case)
    for rank in range(N):
        got = port_run[rank]
        np.testing.assert_allclose(got[f"{case}:loss"], want["loss"],
                                   atol=1e-5, rtol=1e-5)
        me, n = _model_index(case, rank)
        for name, dim in layout.items():
            full = torch.from_numpy(want["grads"][name])
            ref = full if dim is None else port_tp.shard_of(name, full, dim,
                                                            me, n)
            g = got[f"{case}:g:{name}"]
            assert g.shape == tuple(ref.shape), name
            assert _nerr(g, ref.numpy()) <= 1e-5, (rank, name)
            if dim is None:
                assert _nerr(g * n, ref.numpy()) > 1e-2, name


def test_tp_shards_are_quarters_of_the_right_rows(setup, port_run):
    """1/4 slices on every sharded weight, whole norms; rank r's qkv rows
    are q, k and v of heads r (the flax kernel's columns r*8..r*8+7 of each
    third), its out columns the same heads' features."""
    _, _, params = setup
    d, hd = CFG["d_model"], CFG["d_model"] // N
    qkv = params[64]["block_0"]["qkv"]["kernel"]          # [d, 3d]
    out_w = params[64]["block_0"]["out"]["kernel"]        # [d, d]
    for rank in range(N):
        got = port_run[rank]
        w = lambda name: got[f"main:w:{name}"]  # noqa: E731
        assert w("block_0.qkv.weight").shape == (3 * d // N, d)
        assert w("block_0.out.weight").shape == (d, d // N)
        assert w("block_0.up.weight").shape == (CFG["d_ff"] // N, d)
        assert w("block_0.down.weight").shape == (d, CFG["d_ff"] // N)
        assert w("embed.weight").shape == (CFG["vocab"], d // N)
        assert w("lm_head.weight").shape == (CFG["vocab"] // N, d)
        for norm in ("block_0.RMSNorm_0.scale", "final_norm.scale"):
            assert w(norm).shape == (d,)
        cols = np.concatenate([np.arange(p * d + rank * hd,
                                         p * d + (rank + 1) * hd)
                               for p in range(3)])
        np.testing.assert_array_equal(w("block_0.qkv.weight"),
                                      qkv[:, cols].T)
        np.testing.assert_array_equal(
            w("block_0.out.weight"), out_w[rank * hd:(rank + 1) * hd].T)


def test_tp_indivisible_falls_back_replicated(port_run):
    """d_ff 62 on a group of 4: up and down whole on every rank, attention
    and the vocabulary still sharded (the logits and gradients are checked
    above)."""
    for rank in range(N):
        got = port_run[rank]
        assert got["ff62:w:block_0.up.weight"].shape == (62, CFG["d_model"])
        assert got["ff62:w:block_0.down.weight"].shape == (CFG["d_model"],
                                                           62)
        assert got["ff62:w:block_0.qkv.weight"].shape[0] == \
            3 * CFG["d_model"] // N


def test_tp_refuses_a_group_of_another_size(port_run):
    for rank in range(N):
        assert port_run[rank]["flag:wrong_group"] == 1


def test_tp_layout_needs_whole_heads():
    """Attention shards only where each rank gets whole heads: 4 heads over
    3 ranks, or 6 over 4, leave qkv and out whole even where the width
    divides; the MLP shards on its own."""
    for heads, n, d_ff in ((4, 3, 96), (6, 4, 64)):
        model = bft.models.TransformerLM(
            vocab_size=48, num_layers=1, num_heads=heads, d_model=48,
            d_ff=d_ff, device="cpu")
        layout = port_tp.tp_layout(model, n)
        assert layout["block_0.qkv.weight"] is None
        assert layout["block_0.out.weight"] is None
        assert layout["block_0.up.weight"] == 0
        assert layout["block_0.down.weight"] == 1


def test_chip_smoke_virtual_tp_group_matches_dense():
    """``chip_smoke.py``'s virtual TP group of four on the CPU in f32: the
    port's step functions over the four ranks' slices give the dense
    logits and, rank by rank, the dense gradients sliced (1e-5), and both
    planted faults land far beyond."""
    import chip_smoke
    from bluefog_tpu_torch.parallel import flash as fl

    dense = _port_lm(64)
    dense.reset_parameters(seed=1)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, CFG["vocab"], (2, S)))
    res = chip_smoke.virtual_tp(bft, fl, torch, dense,
                                (toks, toks.roll(-1, dims=1)), n=N)
    assert res["errors"]["logits"] <= 1e-5
    assert res["errors"]["grad"] <= 1e-5, res["errors"]
    for fault in chip_smoke.TP_FAULTS:
        assert res["planted"][fault] > 0.1, fault
