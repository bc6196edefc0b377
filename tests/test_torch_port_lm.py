"""Port vs JAX: the chunked LM loss and the LM benchmark's step (CPU).

The JAX test's model (``tests/test_transformer_cp.py``: vocab 64, 2 layers,
2 heads, d 32, d_ff 64, tokens 2x32, chunk 16) in f32, weights carried
across with ``params_from_jax``. ``chunked_ce_loss`` matches JAX's to 1e-5
in the loss and every gradient, and the port's own full-logits loss at the
JAX test's tolerances (loss rtol 1e-6, gradients atol 1e-5 rtol 1e-4), with
and without ``remat_backbone``. ``lm_bench``'s step (plain Adam 1e-3)
matches ``optax.adam(1e-3)`` loss by loss over three steps to 1e-5, and its
``matmul_param_count`` equals the JAX script's.
"""

import importlib.util
import os
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bluefog_tpu import parallel as jax_parallel
from bluefog_tpu.models import TransformerLM as JaxLM
from bluefog_tpu_torch import lm_bench
from bluefog_tpu_torch.models import TransformerLM, lm_loss
from bluefog_tpu_torch.parallel import chunked_ce_loss
from bluefog_tpu_torch.utils import params_from_jax

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64)
CHUNK = 16


@lru_cache(maxsize=None)
def _jax_model():
    jm = JaxLM(**CFG)
    toks, _ = _tokens()
    params = jm.init(jax.random.PRNGKey(1), toks)["params"]
    return jm, params


def _tokens():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, CFG["vocab_size"], (2, 32)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _port_model(params):
    tm = TransformerLM(device="cpu", **CFG)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return tm


def _torch_batch():
    toks, tgts = _tokens()
    return torch.from_numpy(toks).long(), torch.from_numpy(tgts).long()


def _loss_and_grads(tm, loss):
    tm.zero_grad(set_to_none=True)
    value = loss()
    value.backward()
    return float(value.detach()), {n: p.grad.numpy().copy()
                                   for n, p in tm.named_parameters()}


@pytest.mark.parametrize("remat", [False, True])
def test_chunked_ce_matches_jax(remat):
    jm, params = _jax_model()
    toks, tgts = _tokens()
    jl, jg = jax.value_and_grad(lambda p: jax_parallel.chunked_ce_loss(
        jm, p, toks, tgts, chunk=CHUNK, remat_backbone=remat))(params)
    tm = _port_model(params)
    tl, tg = _loss_and_grads(tm, lambda: chunked_ce_loss(
        tm, *_torch_batch(), chunk=CHUNK, remat_backbone=remat))
    np.testing.assert_allclose(tl, float(jl), rtol=0, atol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    assert set(want) == set(tg)
    for name, g in want.items():
        np.testing.assert_allclose(tg[name], g.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_chunked_ce_matches_full_logits(remat):
    """The JAX test's claim on the port: the same loss and gradients as the
    full-logits cross-entropy (a re-association of the same sums)."""
    _, params = _jax_model()
    tm = _port_model(params)
    lf, gf = _loss_and_grads(tm, lambda: lm_loss(tm, _torch_batch()))
    lc, gc = _loss_and_grads(tm, lambda: chunked_ce_loss(
        tm, *_torch_batch(), chunk=CHUNK, remat_backbone=remat))
    np.testing.assert_allclose(lc, lf, rtol=1e-6)
    for name, g in gf.items():
        np.testing.assert_allclose(gc[name], g, atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_chunked_ce_rejects_a_chunk_that_does_not_divide():
    _, params = _jax_model()
    tm = _port_model(params)
    with pytest.raises(ValueError, match="CE chunk 24 must divide the token "
                                         "count 64"):
        chunked_ce_loss(tm, *_torch_batch(), chunk=24)


@lru_cache(maxsize=None)
def _jax_lm_bench():
    """``scripts/lm_bench.py`` loaded by path (it defines functions only)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_lm_bench", os.path.join(_REPO, "scripts", "lm_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("num_experts", [0, 4])
def test_matmul_param_count_matches_jax_script(num_experts):
    cfg = dict(vocab_size=96, num_layers=4, num_heads=2, d_model=32,
               d_ff=128)
    jm = JaxLM(num_experts=num_experts, **cfg)
    params = jm.init(jax.random.PRNGKey(0),
                     np.zeros((1, 8), np.int32))["params"]
    tm = TransformerLM(num_experts=num_experts, device="cpu", **cfg)
    assert lm_bench.matmul_param_count(tm) == \
        _jax_lm_bench().matmul_param_count(params)


def _jax_loss(jm, chunked):
    def loss(p, batch):
        toks, tgts = batch
        if chunked:
            return jax_parallel.chunked_ce_loss(jm, p, toks, tgts,
                                                chunk=CHUNK)
        logits = jm.apply({"params": p}, toks)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tgts).mean()
    return loss


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
def test_lm_bench_step_matches_optax_adam(chunked, remat):
    jm, params = _jax_model()
    toks, tgts = _tokens()
    opt = optax.adam(1e-3)
    state = opt.init(params)
    grad = jax.jit(jax.value_and_grad(_jax_loss(jm, chunked)))
    want = []
    p = params
    for _ in range(3):
        value, g = grad(p, (jnp.asarray(toks), jnp.asarray(tgts)))
        updates, state = opt.update(g, state, p)
        p = optax.apply_updates(p, updates)
        want.append(float(value))
    tm = _port_model(params)
    step = lm_bench.make_step(tm, lm_bench.loss_fn(chunked, remat, CHUNK))
    got = [float(step(_torch_batch())) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got[-1] < got[0]


def test_lm_bench_run_on_cpu_returns_the_jax_scripts_keys():
    res = lm_bench.run(seq_len=64, d_model=32, num_layers=2, num_heads=2,
                       batch=1, vocab=64, steps=2, warmup=1, remat=True,
                       chunked_ce=True, ce_chunk=16, device="cpu")
    keys = {"metric", "seq_len", "d_model", "layers", "batch", "params_m",
            "ms_per_step", "value", "unit", "mfu", "final_loss"}
    assert set(res) == keys | {"device"}
    assert res["device"] == "cpu" and res["mfu"] is None
    assert res["metric"] == "lm_tokens_per_s" and res["unit"] == "tokens/s"
    assert np.isfinite(res["final_loss"]) and res["value"] > 0
