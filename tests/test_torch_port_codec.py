"""Port vs JAX: the wire codecs and the host row functions.

``bluefog_tpu_torch/ops/codec.py`` against ``bluefog_tpu/ops/codec.py`` on
the same numpy rows (from a seed): for int8, fp8 and top-k, in f32 and in
bf16 (the port's bf16 rows are the bit patterns as uint16, JAX's an
``ml_dtypes`` array), at odd lengths and two block sizes, the encoded bytes
are identical and so are the decodes (bit for bit, NaN where NaN). The
fp8 grid is checked where the two casts could part: the block maximum at
448, signed zeros, the padded final block, rows holding inf and NaN. Top-k's
error-feedback residual is identical over 5 steps, ``resolve_edge_spec``
parses identically, ``quantize_blend`` (torch) equals JAX's within 1e-6 of
the largest value.

The counterparts of ``tests/test_codec.py``'s codec-level tests follow
(error bounds, the self-describing block size, the ``pack_row`` codec
hooks, the deposit header layout), then ``pack_row``/``unpack_row``/
``assemble_rows`` against JAX's on a sharded spec.
"""

import struct

import numpy as np
import pytest
import torch

import ml_dtypes
import jax.numpy as jnp

from bluefog_tpu.ops import codec as jcd
from bluefog_tpu.ops import fusion as jfu
from bluefog_tpu.ops import partition as jpart
from bluefog_tpu_torch.ops import codec as cd
from bluefog_tpu_torch.ops import fusion as fu
from bluefog_tpu_torch.ops import windows as W

CODECS = ("int8", "fp8", "topk:0.1")
LENGTHS = (1, 63, 4097, 10_001)
BLOCKS = (256, 4096)


def _row(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + n)
    return (rng.standard_normal(n) * rng.uniform(0.1, 50)).astype(np.float32)


def _both(spec):
    return jcd.resolve(spec), cd.resolve(spec)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("spec", CODECS)
def test_encode_decode_identical_to_jax(spec, dtype, n, block, monkeypatch):
    monkeypatch.setenv("BLUEFOG_WIN_CODEC_BLOCK", str(block))
    monkeypatch.setenv("BFT_WIN_CODEC_BLOCK", str(block))
    x = _row(n)
    j, p = _both(spec)
    if dtype == "bf16":
        xj = x.astype(ml_dtypes.bfloat16)
        xp = xj.view(np.uint16)
        jt, pt = ml_dtypes.bfloat16, cd.BF16
    else:
        xj = xp = x
        jt = pt = np.float32
    ej, ep = j.encode(xj), p.encode(xp)
    assert ep.dtype == np.uint8 and ep.tobytes() == ej.tobytes()
    dj = j.decode(ej, jt, n)
    dp = p.decode(ep, pt, n)
    np.testing.assert_array_equal(dp, np.asarray(dj).view(dp.dtype))
    # weighted decode straight into a slot (the drain's put fold)
    out_j = np.empty(n, np.float32)
    out_p = np.empty(n, np.float32)
    j.decode(ej, np.float32, n, scale_mul=0.5, out=out_j)
    p.decode(ep, np.float32, n, scale_mul=0.5, out=out_p)
    np.testing.assert_array_equal(out_p, out_j)


@pytest.mark.parametrize("spec", ["int8", "fp8"])
def test_quantizer_edge_values_identical(spec, monkeypatch):
    """The block max lands on 448 (fp8) / 127 (int8), signed zeros, an
    all-zero block, a padded final block, and inf / NaN rows."""
    monkeypatch.setenv("BLUEFOG_WIN_CODEC_BLOCK", "64")
    monkeypatch.setenv("BFT_WIN_CODEC_BLOCK", "64")
    rows = [
        np.concatenate([np.linspace(-448, 448, 64), np.zeros(64),
                        [-0.0, 0.0, 1e-30, -1e-30, 447.99, 448.01],
                        _row(37)]).astype(np.float32),
        np.array([1.0, -np.inf, 2.0, np.nan] * 20, np.float32),
        np.array([np.inf] * 70, np.float32),
    ]
    j, p = _both(spec)
    for x in rows:
        ej, ep = j.encode(x), p.encode(x)
        assert ep.tobytes() == ej.tobytes()
        np.testing.assert_array_equal(
            p.decode(ep, np.float32, x.size),
            j.decode(ej, np.float32, x.size))
    if spec == "fp8":
        # the block whose max is 448 keeps scale 1 and code 0x7e for 448
        enc = p.encode(rows[0])
        scale = enc[4:8].view(np.float32)[0]
        assert scale == np.float32(1.0)
        assert enc[4 + 4 * (-(-rows[0].size // 64)) + 63] == 0x7E


def test_topk_error_feedback_identical_over_5_steps():
    """EF-SGD with each package's top-k: ``base = x + e``, send
    ``C(base)``, keep ``e = base - decode``: the residuals agree."""
    j, p = _both("topk:0.05")
    e_j = np.zeros(5000, np.float32)
    e_p = np.zeros(5000, np.float32)
    for step in range(5):
        x = _row(5000, seed=step)
        bj, bp = x + e_j, x + e_p
        ej, ep = j.encode(bj), p.encode(bp)
        assert ep.tobytes() == ej.tobytes()
        e_j = bj - j.decode(ej, np.float32, x.size)
        e_p = bp - p.decode(ep, np.float32, x.size)
        np.testing.assert_array_equal(e_p, e_j)
    assert np.abs(e_p).sum() > 0


@pytest.mark.parametrize("spec", [
    None, "", "none", "int8", "FP8", "topk", "topk:0.05", "in8",
    "topk:abc", "none;0>1=int8;2>3=topk:0.05", "int8;1>0=none",
    "none;garbage;0-1=int8;3>4=fp8", "fp8;;2>1=topk"])
def test_resolve_edge_spec_parses_identically(spec):
    def sig(c):
        return None if c is None else (c.cid, c.name,
                                       getattr(c, "frac", None))

    jb, jo = jcd.resolve_edge_spec(spec)
    pb, po = cd.resolve_edge_spec(spec)
    assert sig(pb) == sig(jb)
    assert {e: sig(c) for e, c in po.items()} == \
        {e: sig(c) for e, c in jo.items()}
    assert sig(cd.resolve(spec)) == sig(jcd.resolve(spec))
    assert sig(cd.state_codec_for(pb)) == sig(jcd.state_codec_for(jb))


@pytest.mark.parametrize("cid", [cd.CODEC_NONE, cd.CODEC_INT8, cd.CODEC_FP8,
                                 cd.CODEC_TOPK])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_blend_matches_jax(cid, dtype):
    x = _row(512, seed=3)
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = np.asarray(jcd.quantize_blend(jnp.asarray(x, jt), cid),
                      np.float32)
    got = cd.quantize_blend(torch.from_numpy(x).to(tt), cid).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    if cid in (cd.CODEC_NONE, cd.CODEC_TOPK):
        t = torch.from_numpy(x)
        assert cd.quantize_blend(t, cid) is t


# -- the counterparts of tests/test_codec.py --------------------------------

def test_int8_roundtrip_error_bound():
    rng = np.random.RandomState(0)
    x = (rng.randn(20_000) * rng.uniform(0.1, 50)).astype(np.float32)
    c = cd.Int8Codec()
    enc = c.encode(x)
    dec = c.decode(enc, np.float32, x.size)
    for b in range(0, x.size, 4096):
        seg = x[b:b + 4096]
        bound = np.abs(seg).max() / 127.0 * 0.5 + 1e-7
        assert np.abs(dec[b:b + 4096] - seg).max() <= bound * 1.01
    assert enc.nbytes < x.nbytes / 3.5


def test_fp8_roundtrip_error_bound():
    x = (np.random.RandomState(1).randn(10_000) * 3).astype(np.float32)
    c = cd.Fp8Codec()
    enc = c.encode(x)
    dec = c.decode(enc, np.float32, x.size)
    amax = np.abs(x).max()
    assert np.all(np.abs(dec - x) <= np.maximum(np.abs(x) * 0.0825,
                                                amax / 448.0))
    assert enc.nbytes < x.nbytes / 3.5


def test_topk_keeps_largest_exactly():
    x = np.random.RandomState(2).randn(1000).astype(np.float32)
    c = cd.TopKCodec(0.1)
    enc = c.encode(x)
    dec = c.decode(enc, np.float32, x.size)
    top = np.argsort(np.abs(x))[-100:]
    np.testing.assert_array_equal(dec[top], x[top])
    rest = np.setdiff1d(np.arange(x.size), top)
    np.testing.assert_array_equal(dec[rest], 0.0)
    assert enc.nbytes == 4 + 8 * 100


def test_topk_decode_rejects_out_of_range_index():
    c = cd.TopKCodec(0.5)
    enc = c.encode(np.ones(16, np.float32))
    with pytest.raises(ValueError, match="beyond"):
        c.decode(enc, np.float32, 4)


def test_resolve_grammar():
    assert cd.resolve(None) is None and cd.resolve("none") is None
    assert isinstance(cd.resolve("int8"), cd.Int8Codec)
    assert isinstance(cd.resolve("fp8"), cd.Fp8Codec)
    assert cd.resolve("topk:0.05").frac == 0.05
    assert cd.resolve("topk").frac == 0.01
    assert cd.resolve("in8") is None
    assert cd.by_id(cd.CODEC_INT8).cid == cd.CODEC_INT8
    with pytest.raises(ValueError, match="unknown wire codec"):
        cd.by_id(9)
    with pytest.raises(ValueError, match="fraction"):
        cd.TopKCodec(0.0)


def test_codec_block_knob_is_self_describing(monkeypatch):
    x = np.arange(10_000, dtype=np.float32)
    monkeypatch.setenv("BFT_WIN_CODEC_BLOCK", "256")
    enc = cd.Int8Codec().encode(x)
    monkeypatch.setenv("BFT_WIN_CODEC_BLOCK", "8192")
    dec = cd.Int8Codec().decode(enc, np.float32, x.size)
    assert np.abs(dec - x).max() <= x.max() / 127.0 * 0.5 + 1e-6


def test_pack_deposit_codec_header_layout():
    payload = np.arange(8, dtype=np.float32)
    legacy = W._pack_deposit(W._DEP_ACC, 1, 2.5, payload)
    assert bytes(legacy[0]) == struct.pack("<BBdI", 1, 1, 2.5, 1)
    enc = cd.Int8Codec().encode(payload)
    recs = W._pack_deposit(W._DEP_PUT, 0, 0.0, enc,
                           codec_id=cd.CODEC_INT8, wt=0.25)
    mode, has_p, pc, nchunks = struct.unpack_from("<BBdI", recs[0])
    assert mode == cd.CODEC_INT8 << W._DEP_CODEC_SHIFT
    assert struct.unpack_from("<dQ", recs[0], W._DEP_HDR) == (0.25,
                                                               enc.nbytes)
    assert b"".join(bytes(c) for c in recs[1:]) == enc.tobytes()


# -- the host row functions --------------------------------------------------

def _leaves():
    rng = np.random.default_rng(11)
    return [rng.standard_normal((2, 3)).astype(np.float32),
            rng.standard_normal((4,)).astype(np.float32),
            rng.standard_normal((5, 6)).astype(np.float32)]


def _specs(shard_factor=None):
    leaves = _leaves()
    jshard = None
    if shard_factor:
        jshard = jpart.build_shard_spec(
            [x.shape for x in leaves], [x.dtype for x in leaves],
            shard_factor)
    jspec = jfu.make_spec([jnp.asarray(x)[None] for x in leaves],
                          shard=jshard)
    pspec = fu.make_spec([torch.from_numpy(x) for x in leaves])._replace(
        shard=jshard)
    return leaves, jspec, pspec


@pytest.mark.parametrize("codec", [None, "int8", "fp8"])
def test_pack_unpack_row_identical_to_jax(codec):
    leaves, jspec, pspec = _specs()
    jc, pc = (jcd.resolve(codec), cd.resolve(codec)) if codec else \
        (None, None)
    rj = jfu.pack_row(leaves, jspec, codec=jc)
    rp = fu.pack_row([torch.from_numpy(x) for x in leaves], pspec, codec=pc)
    assert rp.tobytes() == np.asarray(rj).tobytes()
    for a, b in zip(fu.unpack_row(rp, pspec, codec=pc),
                    jfu.unpack_row(rj, jspec, codec=jc)):
        np.testing.assert_array_equal(a, b)


def test_pack_row_shards_and_assemble_rows_identical_to_jax():
    leaves, jspec, pspec = _specs(shard_factor=3)
    for s in range(3):
        rj = jfu.pack_row(leaves, jspec, shard=s)
        rp = fu.pack_row(leaves, pspec, shard=s)
        assert rp.tobytes() == np.asarray(rj).tobytes()
    rows = [fu.pack_row(leaves, pspec, shard=s) for s in range(3)]
    for got, want, x in zip(fu.assemble_rows(rows, pspec),
                            jfu.assemble_rows(rows, jspec), leaves):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, x)
    with pytest.raises(ValueError):
        fu.assemble_rows(rows[:2], pspec)


def test_bf16_host_rows_round_trip():
    x = torch.randn(17, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    h = fu.to_host(x)
    assert h.dtype == cd.BF16
    np.testing.assert_array_equal(h, x.float().numpy().astype(
        ml_dtypes.bfloat16).view(np.uint16))
    assert torch.equal(fu.from_host(h, torch.bfloat16), x)
    np.testing.assert_array_equal(cd.to_f32(h), x.float().numpy())
