"""Port vs JAX: the flash-attention blocks and their gradients (f32, CPU).

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
JAX side runs the Pallas kernels in interpret mode, as ``test_flash.py``
does. S=768 gives the JAX kernels 3x3 tiles of 256, so all three causal
tile classes (dead, interior, diagonal) occur. Tolerances: the forward
partials agree to 1e-5, absolute and relative (f32 products summed in
another order; o is an unnormalised sum of up to S terms, ~10 here); the
backward and the ``flash_attention`` gradients to 2e-5, the JAX suite's
own bound for f32 flash gradients (``test_flash.py:93``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bluefog_tpu.parallel import flash as jflash
from bluefog_tpu_torch.parallel import flash as tflash

B, S, H, D = 1, 768, 2, 32
OFFSETS = [(0, 0), (S, 0), (0, S)]


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offs", OFFSETS)
def test_port_flash_block_matches_jax(causal, offs):
    q, k, v = _arrays(0, *[(B, S, H, D)] * 3)
    want = jflash.flash_block(q, k, v, *offs, causal=causal, interpret=True)
    got = tflash.flash_block(*_t(q, k, v), *offs, causal=causal)
    for name, a, b in zip("oml", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offs", OFFSETS)
def test_port_flash_block_bwd_matches_jax(causal, offs):
    q, k, v, g = _arrays(1, *[(B, S, H, D)] * 4)
    o, m, l = jflash.flash_block(q, k, v, *offs, causal=causal,
                                 interpret=True)
    out = np.asarray(o) / np.maximum(np.asarray(l), 1e-30)[..., None]
    d_term = (g * out).sum(-1)
    want = jflash.flash_block_bwd(q, k, v, g, d_term, m, l, *offs,
                                  causal=causal, interpret=True)
    got = tflash.flash_block_bwd(*_t(q, k, v, g, d_term, m, l), *offs,
                                 causal=causal)
    for name, a, b in zip(["dq", "dk", "dv"], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_port_flash_attention_grads_match_jax(causal):
    q, k, v = _arrays(2, *[(B, 256, H, D)] * 3)

    def jloss(q, k, v):
        out = jflash.flash_attention(q, k, v, causal=causal, interpret=True)
        return jnp.sum(out * jnp.cos(out))

    jq, jk, jv = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=causal)
    (out * out.cos()).sum().backward()
    for name, a, b in zip("qkv", (tq, tk, tv), (jq, jk, jv)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_port_blockwise_oracle_matches_jax(causal):
    q, k, v = _arrays(3, *[(2, 64, H, 8)] * 3)
    want = jflash._blockwise_attention(q, k, v, causal, 16)
    got = tflash._blockwise_attention(*_t(q, k, v), causal, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
