"""The forward kernel's numerics, checked on the CPU.

The CUDA forward kernel (``csrc/flash_fwd.cu``) walks K/V tiles of a fixed
width with an online softmax whose running max m is kept in scaled units: per
tile, m_new = max(m, rowmax(s_raw) * scale), p = exp2(s_raw * scale * log2(e)
- m_new * log2(e)), alpha = exp2((m - m_new) * log2(e)), l = alpha * l +
sum(p) from the unrounded p, and o = alpha * o + bf16(p) . V, with p rounded
at the running max. The helper below repeats that scheme in f32 torch, and
the tests hold it to the JAX Pallas kernel (interpret mode, bf16 inputs, so
JAX rounds its p to bf16 too) at S=768, where JAX's 256-wide tiles give all
three causal tile classes. Two more tests pin the pure parts of the kernel's
tooling: the variant script's settings against the source's constants, and
the build-log lines ``chip_smoke.py`` prints.

Tolerances: m to 1e-6 absolute (the same f32 products, summed in another
order, times the same scale); l to 1e-5 relative (f32 sums of exp in another
order); o/l to 2.5e-3 absolute, half the limit ``chip_smoke.py`` holds the
card to (5e-3): both sides round p to bf16 (2^-9 relative), but at different
running maxes (the kernel's tiles are 64 or 128 wide, JAX's 256), so single
p values differ by up to two bf16 ulps before the average over keys.
Measured here: m 4.8e-7, l 7.7e-7, o/l 1.31e-3.
"""

import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.parallel import flash as jflash
from bluefog_tpu_torch.parallel import _build
from bluefog_tpu_torch.parallel import flash as tflash

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "scripts"))
import chip_smoke  # noqa: E402
import torch_port_fwd_variants  # noqa: E402

B, S, H, D = 1, 768, 2, 64
OFFSETS = [(0, 0), (S, 0), (0, S), (37, 0)]
TILES = [64, 128]          # the kernel's K/V tile widths (KROWS)


def _kernel_scheme(q, k, v, q_off, k_off, causal, kt):
    """(o, m, l) with the CUDA kernel's tiles and cast points, f32."""
    Sq, Sk = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    c = scale * tflash._LOG2E
    o = torch.zeros((B, H, Sq, q.shape[-1]))
    m = torch.full((B, H, Sq), tflash._NEG)
    l = torch.zeros((B, H, Sq))
    q_pos = q_off + torch.arange(Sq)
    for k0 in range(0, Sk, kt):
        kb, vb = k[:, k0:k0 + kt], v[:, k0:k0 + kt]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb)            # raw scores
        if causal:
            k_pos = k_off + k0 + torch.arange(kb.shape[1])
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1) * scale)
        alpha = torch.exp2((m - m_new) * tflash._LOG2E)
        p = torch.exp2(s * c - (m_new * tflash._LOG2E)[..., None])
        l = alpha * l + p.sum(dim=-1)
        p_b = p.to(torch.bfloat16).float()
        o = alpha[..., None] * o + torch.einsum("bhqk,bkhd->bhqd", p_b, vb)
        m = m_new
    return o.permute(0, 2, 1, 3), m.permute(0, 2, 1), l.permute(0, 2, 1)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, H, D))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]


def _jax(q, k, v, offs, causal):
    """JAX ``flash_block`` on the same bf16 values, as f32 torch tensors."""
    args = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    out = jflash.flash_block(*args, *offs, causal=causal, interpret=True)
    return [torch.from_numpy(np.array(x, np.float32)) for x in out]


def _max(t):
    return float(t.max()) if t.numel() else 0.0


def _both(offs, causal, kt, seed=0):
    q, k, v = _inputs(seed)
    got = _kernel_scheme(q.float(), k.float(), v.float(), *offs, causal, kt)
    return got, _jax(q, k, v, offs, causal)


@pytest.mark.parametrize("kt", TILES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offs", OFFSETS)
def test_kernel_scheme_matches_jax(offs, causal, kt):
    (o, m, l), (jo, jm, jl) = _both(offs, causal, kt)
    assert _max((m - jm).abs()) <= 1e-6
    live = jl > 0
    assert torch.equal(live, l > 0)
    assert _max(((l - jl).abs() / jl.clamp_min(1e-30))[live]) <= 1e-5
    out = o / l.clamp_min(1e-30)[..., None]
    jout = jo / jl.clamp_min(1e-30)[..., None]
    assert _max((out - jout)[live].abs()) <= 2.5e-3


@pytest.mark.parametrize("kt", TILES)
@pytest.mark.parametrize("offs", [(0, S), (0, 37)])
def test_rows_with_no_live_key(offs, kt):
    """A row whose keys all lie in its future keeps m = -1e30, l = 0 and
    o = 0, in the scheme as in JAX: every row for (0, S), the first 37 for
    (0, 37)."""
    (o, m, l), (jo, jm, jl) = _both(offs, True, kt, seed=1)
    dead = slice(0, min(S, offs[1]))
    for mm, ll, oo in ((m, l, o), (jm, jl, jo)):
        assert (mm[:, dead] == tflash._NEG).all()
        assert (ll[:, dead] == 0).all()
        assert (oo[:, dead] == 0).all()
    assert (l[:, offs[1]:] > 0).all() and (jl[:, offs[1]:] > 0).all()


def test_fwd_variants_apply_to_the_source():
    """Every variant's constants exist in ``flash_fwd.cu``, and the committed
    setting is one of the variants timed (its substitutions are empty)."""
    text = (_build._CSRC / "flash_fwd.cu").read_text()
    subs = torch_port_fwd_variants.variants(text)
    assert subs["committed"] == []
    same = [n for n, s in subs.items() if n != "committed" and not s]
    assert len(same) == 1, same
    for pairs in subs.values():
        for old, new in pairs:
            assert old in text and old != new


def test_ptxas_lines_keep_spills_and_serialisation():
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function 'k' for 'sm_90a'",
        "ptxas info    : (C7518) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas warning : Registers are spilled to local memory"])
    kept = chip_smoke.ptxas_lines(log)
    assert len(kept) == 4
    assert kept[0].startswith("ptxas info    : (C7518)")
    assert not any("gmem" in k or "Compiling" in k for k in kept)
