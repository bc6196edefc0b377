"""The backward kernels' numerics and registry, checked on the CPU.

The CUDA backward kernels (``csrc/flash_bwd.cu``) run every product in bf16:
g is rounded to bf16, P = exp2(s*scale*log2(e) - lse2) comes from the
wrapper's packed row stats (``flash._bwd_stats``), dS = P*(dP - d), and P and
dS are rounded to bf16 before the dv, dq and dk products. The helper below
repeats that scheme in f32 torch on the CPU, and the test holds it to the JAX
Pallas backward (interpret mode) on bf16-valued inputs at S=768, where all
three causal tile classes occur: normalised by the largest reference value,
within 5e-3, half the limit ``chip_smoke.py`` holds the card to (1e-2). The
other tests pin the pure parts of the port's kernel plumbing: the bounds
``chip_smoke.py`` reports, the kernel registries, and the wrappers' operand
checks.
"""

import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from bluefog_tpu.parallel import flash as jflash
from bluefog_tpu_torch.parallel import _build
from bluefog_tpu_torch.parallel import flash as tflash

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
import chip_smoke  # noqa: E402

B, S, H, D = 1, 768, 2, 32
OFFSETS = [(0, 0), (S, 0), (0, S)]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _kernel_scheme(q, k, v, g, d_term, m, l, q_off, k_off, causal):
    """(dq, dk, dv) with the CUDA kernels' cast points, f32 accumulation."""
    Sq = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    stats = tflash._bwd_stats(d_term, m, l)[:, :, :Sq]     # [B, H, Sq, 2]
    lse2, d = stats[..., 0, None], stats[..., 1, None]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    p = torch.exp2(s * (scale * tflash._LOG2E) - lse2)
    if causal:
        allowed = tflash._allowed(Sq, k.shape[1], q_off, k_off, q.device)
        p = torch.where(allowed, p, torch.zeros_like(p))
    g_b = _bf16(g)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", g_b, v) - d)
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), g_b)
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), q) * scale
    return dq, dk, dv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offs", OFFSETS)
def test_kernel_cast_points_match_jax(causal, offs):
    rng = np.random.default_rng(4)
    q, k, v, g = (_bf16(torch.from_numpy(
        rng.standard_normal((B, S, H, D)).astype(np.float32))).numpy()
        for _ in range(4))
    o, m, l = (np.asarray(x) for x in jflash.flash_block(
        q, k, v, *offs, causal=causal, interpret=True))
    d_term = (g * o / np.maximum(l, 1e-30)[..., None]).sum(-1)
    want = jflash.flash_block_bwd(q, k, v, g, d_term, m, l, *offs,
                                  causal=causal, interpret=True)
    got = _kernel_scheme(*(torch.from_numpy(np.array(x))
                           for x in (q, k, v, g, d_term, m, l)),
                         *offs, causal)
    for name, a, b in zip(["dq", "dk", "dv"], got, want):
        b = torch.from_numpy(np.array(b))
        err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))
        assert err <= 5e-3, (name, err)


def test_kernel_bounds_at_the_headline_shape():
    bounds = chip_smoke.kernel_bounds(1, 8192, 16, 128)
    for name, want in (("flash_fwd", 0.278), ("flash_bwd_dq", 0.417),
                       ("flash_bwd_dkv", 0.556)):
        assert bounds[name]["bound_by"] == "operations"
        assert abs(bounds[name]["bound_ms"] / want - 1) <= 0.01, (
            name, bounds[name])


def test_kernel_registries_agree():
    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    sources = {f[:-3] for f in os.listdir(csrc) if f.endswith(".cu")}
    assert sources <= set(_build.KERNEL_SOURCES)
    with open(tflash.__file__) as f:
        libs = set(re.findall(r'_fn\("(\w+)"', f.read()))
    assert libs and libs <= set(_build.KERNEL_SOURCES)
    assert set(tflash.launch_counts) <= set(chip_smoke.KERNELS)
    for name, (src, replaces) in chip_smoke.KERNELS.items():
        assert os.path.isfile(os.path.join(_REPO, src)), (name, src)
        path, line = replaces.rsplit(":", 1)
        with open(os.path.join(_REPO, path)) as f:
            text = f.read().splitlines()[int(line) - 1]
        assert text.startswith("def ") and "kernel" in text, (name, text)


def _operands(Sq=64, D=64):
    q, k, v = (torch.zeros((1, Sq, 2, D), dtype=torch.bfloat16)
               for _ in range(3))
    g = torch.zeros((1, Sq, 2, D))
    d_term, m, l = (torch.zeros((1, Sq, 2)) for _ in range(3))
    return [q, k, v, g, d_term, m, l]


@pytest.mark.parametrize("case, error", [
    ("q_dtype", TypeError), ("head_dim", ValueError),
    ("k_not_contiguous", ValueError)])
def test_check_qkv_refuses(case, error):
    q, k, v = _operands(D=32 if case == "head_dim" else 64)[:3]
    if case == "q_dtype":
        q = q.float()
    if case == "k_not_contiguous":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(error):
        tflash._check_qkv(q, k, v)


@pytest.mark.parametrize("case, error", [
    ("g_dtype", TypeError), ("l_dtype", TypeError),
    ("m_not_contiguous", ValueError), ("head_dim", ValueError)])
def test_bwd_operands_refuse(case, error):
    ops = _operands(D=96 if case == "head_dim" else 64)
    if case == "g_dtype":
        ops[3] = ops[3].to(torch.bfloat16)
    if case == "l_dtype":
        ops[6] = ops[6].double()
    if case == "m_not_contiguous":
        ops[5] = ops[5].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(error):
        tflash._bwd_operands(*ops)


def test_bwd_operands_pack_stats():
    ops = _operands(Sq=200)
    ops[5][:] = 2.0                    # m
    ops[6][:, :100] = 4.0              # l; rows 100.. have no live key
    ops[4][:] = 3.0                    # d_term
    shape, g_b, stats = tflash._bwd_operands(*ops)
    assert shape == (1, 200, 200, 2, 64) and g_b.dtype == torch.bfloat16
    assert stats.shape == (1, 2, 256, 2)
    lse2 = stats[..., 0]
    assert torch.allclose(lse2[:, :, :100],
                          torch.full_like(lse2[:, :, :100],
                                          2.0 * tflash._LOG2E + 2.0))
    assert torch.isinf(lse2[:, :, 100:]).all() and (lse2[:, :, 100:] > 0).all()
    assert (stats[:, :, :200, 1] == 3.0).all()
    assert (stats[:, :, 200:, 1] == 0.0).all()
