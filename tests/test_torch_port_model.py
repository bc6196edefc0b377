"""Port vs JAX: the transformer LM on the same weights (CPU).

``params_from_jax`` carries a flax ``TransformerLM`` init (L=2, d=64, H=4,
V=128, S=64) into the port's model; logits must agree to 1e-4 in f32 and,
in bf16, to 2e-2 of the largest logit (the two frameworks round bf16
intermediates at different places: gelu, the residual adds, the attention
output), with dense or flash attention. In f32 the mean cross-entropy loss
agrees to 1e-5 and every parameter gradient to 1e-5.
"""

from functools import lru_cache, partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bluefog_tpu.models.transformer import TransformerLM as JaxLM
from bluefog_tpu.parallel.flash import flash_attention as jax_flash
from bluefog_tpu_torch.models import TransformerLM, lm_loss
from bluefog_tpu_torch.parallel.flash import flash_attention
from bluefog_tpu_torch.utils import params_from_jax

CFG = dict(vocab_size=128, num_layers=2, num_heads=4, d_model=64, d_ff=256)
S = 64


@lru_cache(maxsize=None)
def _models(dtype_name: str, attn: str):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
    jattn = None if attn == "dense" else partial(jax_flash, causal=True,
                                                 interpret=True)
    jm = JaxLM(dtype=jdt, attn_fn=jattn, **CFG)
    params = jm.init(jax.random.PRNGKey(4), np.zeros((1, S), np.int32))
    tm = TransformerLM(dtype=tdt, device="cpu",
                       attn_fn=None if attn == "dense" else flash_attention,
                       **CFG)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params["params"], tm


def _tokens():
    rng = np.random.default_rng(9)
    toks = rng.integers(0, CFG["vocab_size"], (2, S)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_logits_match_jax(dtype, attn):
    jm, params, tm = _models(dtype, attn)
    toks, _ = _tokens()
    want = np.asarray(jm.apply({"params": params}, toks))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long()).numpy()
    assert got.shape == want.shape == (2, S, CFG["vocab_size"])
    atol = 1e-4 if dtype == "f32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_port_loss_and_grads_match_jax(attn):
    jm, params, tm = _models("f32", attn)
    toks, tgts = _tokens()

    def jloss(p):
        logits = jm.apply({"params": p}, toks)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tgts).mean()

    jl, jg = jax.value_and_grad(jloss)(params)
    tm.zero_grad(set_to_none=True)
    tl = lm_loss(tm, (torch.from_numpy(toks).long(),
                      torch.from_numpy(tgts).long()))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0, atol=1e-5)
    tgrads = {k: v.grad for k, v in tm.named_parameters()}
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    assert set(want) == set(tgrads)
    for name, g in want.items():
        np.testing.assert_allclose(tgrads[name].numpy(), g.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_params_from_jax_rejects_unknown_leaf():
    # ``bias`` maps since the vision models (their Dense and Conv have one)
    with pytest.raises(KeyError):
        params_from_jax({"block_0": {"qkv": {"gamma": np.zeros(3)}}})
    with pytest.raises(KeyError):
        params_from_jax({"params": {"bn": {"scale": np.ones(3)}},
                         "batch_stats": {"bn": {"count": np.zeros(3)}}})
