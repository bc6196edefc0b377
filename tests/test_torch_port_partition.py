"""Port vs JAX: the partition rules and the shard half of the fusion layer.

``bluefog_tpu_torch/ops/partition.py`` and ``ops/fusion.py``'s shard
functions against ``bluefog_tpu/ops/partition.py`` and ``fusion.py``, the
counterparts of ``tests/test_sharded_windows.py:63-193``, in process:

* the rule grammar (malformed terms skipped, the auto rule last) and
  first-match axis decisions, equal to JAX's for the same names;
* piece tables: from the same shapes, dtypes, names, rules, factor and
  floor (seeded shape lists, LM-shaped lists, mixed dtypes), the port's
  ``ShardSpec`` equals JAX's exactly; ``leaf_names`` reads
  ``named_parameters()`` (``.``-joined, JAX matches ``/``-joined flax
  paths), so a rule written for either matches the same parameters;
* ``pack_shard`` / ``scatter_shard`` against JAX's ``pack_shard`` /
  ``scatter_shard`` on the same rows (bit for bit, f32 and bf16, pad tail
  zero and ignored), and the scatter in place: only the shard's pieces
  change;
* ``pack_row(shard=)`` / ``assemble_rows`` round trips over factors x
  codecs x dtype mixes, byte-identical to JAX's rows and payloads;
* S=1 byte identity with the unsharded row, with and without a codec.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from bluefog_tpu.ops import codec as jcd
from bluefog_tpu.ops import fusion as jfu
from bluefog_tpu.ops import partition as jpart
from bluefog_tpu_torch.ops import codec as cd
from bluefog_tpu_torch.ops import fusion as fu
from bluefog_tpu_torch.ops import partition as part


def _lm_shapes():
    """LM-shaped (name, shape) pairs: embedding, attention block, norms."""
    vocab, d = 50, 12
    return [("embedding", (vocab, d)), ("block0/qkv", (d, 3 * d)),
            ("block0/proj", (d, d)), ("block0/mlp_up", (d, 4 * d)),
            ("block0/ln_scale", (d,)), ("head_bias", (vocab,))]


def _seeded_shapes(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(3, 9))):
        nd = int(rng.integers(0, 4))
        out.append((f"l{i}/w{nd}",
                    tuple(int(v) for v in rng.integers(1, 13, nd))))
    return out


def test_parse_rules_grammar_and_fallback():
    spec = "embedding=0, qkv=1, norm=none, .*=largest"
    rules, jrules = part.parse_rules(spec), jpart.parse_rules(spec)
    assert len(rules) == 5
    assert [r[1] for r in rules] == [r[1] for r in jrules]
    assert [r[0].pattern for r in rules] == [r[0].pattern for r in jrules]
    rules = part.parse_rules("oops, [=bad, x=seven")
    assert [r[1] for r in rules] == [
        r[1] for r in jpart.parse_rules("oops, [=bad, x=seven")]
    assert rules[-1][1] == "largest"
    assert [r[1] for r in part.parse_rules(None)] == ["largest"]


@pytest.mark.parametrize("spec", [None, "qkv=1,ln=none,.*=0", "w2=-1",
                                  "emb=5,proj=none"])
def test_match_partition_rules_first_match_equals_jax(spec):
    names = ["embedding", "block0/qkv", "block0/ln_scale", "scalar",
             "block0/proj", "x/w2"]
    shapes = [(50, 12), (12, 36), (12,), (), (12, 12), (4, 9)]
    got = part.match_partition_rules(part.parse_rules(spec), names, shapes)
    want = jpart.match_partition_rules(jpart.parse_rules(spec), names,
                                       shapes)
    assert got == want
    assert got[3] is None  # a scalar never partitions


@pytest.mark.parametrize("factor", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("seed", range(4))
def test_piece_tables_equal_jax(seed, factor):
    named = _seeded_shapes(seed) + _lm_shapes()
    names = [n for n, _ in named]
    shapes = [s for _, s in named]
    rng = np.random.default_rng(100 + seed)
    kinds = rng.integers(0, 2, len(shapes))
    tdt = [torch.bfloat16 if k else torch.float32 for k in kinds]
    jdt = [ml_dtypes.bfloat16 if k else np.float32 for k in kinds]
    for rules, floor in ((None, 0), ("qkv=1,ln=none,.*=largest", 256),
                         ("embedding=0,w2=0", 64)):
        got = part.build_shard_spec(shapes, tdt, factor, names=names,
                                    rules_spec=rules, floor_bytes=floor)
        want = jpart.build_shard_spec(shapes, jdt, factor, names=names,
                                      rules_spec=rules, floor_bytes=floor)
        assert tuple(got) == tuple(want), (rules, floor)
        assert sum(got.totals) == sum(int(np.prod(s)) for s in shapes)


def test_build_shard_spec_floor_keeps_small_leaves_whole():
    named = _lm_shapes()
    sh = part.build_shard_spec([s for _, s in named],
                               [torch.float32] * len(named), 4,
                               names=[n for n, _ in named], floor_bytes=256)
    assert max(sh.totals) < 2 * min(sh.totals)
    ln = [n for n, _ in named].index("block0/ln_scale")
    pieces = [p for ps in sh.pieces for p in ps if p[0] == ln]
    assert len(pieces) == 1 and pieces[0][1] == -1


def test_leaf_names_are_named_parameters():
    """The port's names are ``named_parameters()``'s, ``.``-joined; a rule
    naming a parameter picks it as JAX's does for the ``/``-joined path."""
    model = torch.nn.Sequential(torch.nn.Linear(6, 10), torch.nn.ReLU(),
                                torch.nn.Linear(10, 4))
    names = part.leaf_names(model)
    assert names == ["0.weight", "0.bias", "2.weight", "2.bias"]
    assert part.leaf_names(model.named_parameters()) == names
    sh = part.spec_for_tree(model, 2, rules_spec=r"^2\.weight=1")
    jsh = jpart.build_shard_spec(
        [tuple(p.shape) for p in model.parameters()], [np.float32] * 4, 2,
        names=["0/weight", "0/bias", "2/weight", "2/bias"],
        rules_spec=r"^2/weight=1")
    assert tuple(sh) == tuple(jsh)
    # 2.weight cut along axis 1 (its largest is axis 0)
    assert [p[:2] for p in sh.pieces[0] if p[0] == 2] == [(2, 1)]


def _leaves(seed: int):
    """Mixed-dtype rows of one rank: (torch tensors, JAX-side numpy)."""
    rng = np.random.default_rng(seed)
    f = [rng.standard_normal((7, 5)), rng.standard_normal((33,)) * 3,
         rng.standard_normal((4, 3, 2)), rng.standard_normal(())]
    dts = [np.float32, "bf16", np.float32, np.float32]
    tt, jj = [], []
    for a, dt in zip(f, dts):
        if dt == "bf16":
            t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
            tt.append(t)
            jj.append(np.asarray(a, np.float32).astype(ml_dtypes.bfloat16))
        else:
            tt.append(torch.from_numpy(np.asarray(a, np.float32)))
            jj.append(np.asarray(a, np.float32))
    return tt, jj


def _specs(tt, jj, factor, floor=0):
    shapes = [tuple(t.shape) for t in tt]
    sh = part.build_shard_spec(shapes, [t.dtype for t in tt], factor,
                               floor_bytes=floor)
    jsh = jpart.build_shard_spec(shapes, [a.dtype for a in jj], factor,
                                 floor_bytes=floor)
    assert tuple(sh) == tuple(jsh)
    return (fu.make_spec(tt, shard=sh),
            jfu.make_spec([jnp.asarray(a)[None] for a in jj], shard=jsh))


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("all_f32", [True, False])
@pytest.mark.parametrize("factor", [2, 3, 4])
def test_pack_shard_and_scatter_shard_equal_jax(factor, all_f32):
    tt, jj = _leaves(3 + factor)
    if all_f32:
        tt = [t.float() for t in tt]
        jj = [np.asarray(a, np.float32) for a in jj]
    spec, jspec = _specs(tt, jj, factor)
    assert spec.buffer_dtype == torch.float32  # promoted over the bf16
    out = [torch.zeros_like(t) for t in tt]
    jout = [jnp.zeros_like(jnp.asarray(a)[None]) for a in jj]
    for s in range(factor):
        row = fu.pack_shard(tt, spec, s)
        jrow = np.asarray(jfu.pack_shard([jnp.asarray(a)[None] for a in jj],
                                         jspec, s))[0]
        assert row.shape == (spec.shard.row_len,)
        np.testing.assert_array_equal(row.numpy(), jrow)
        tail = spec.shard.totals[s]
        assert not row[tail:].any()
        before = [t.clone() for t in out]
        fu.scatter_shard(out, row, spec, s)
        jout = jfu.scatter_shard(jout, jnp.asarray(jrow)[None], jspec, s)
        for a, b in zip(out, jout):
            np.testing.assert_array_equal(
                _as_np(a), np.asarray(b[0]).astype(np.float32))
        # only shard s's pieces changed
        touched = {p[0] for p in spec.shard.pieces[s]}
        for i, (a, b) in enumerate(zip(before, out)):
            if i not in touched:
                assert torch.equal(a, b)
    for a, b in zip(tt, out):
        assert torch.equal(a, b)


def test_scatter_shard_writes_parameters_in_place():
    p = torch.nn.Parameter(torch.arange(24, dtype=torch.float32)
                           .reshape(6, 4))
    sh = part.build_shard_spec([(6, 4)], [torch.float32], 2)
    spec = fu.make_spec([p.detach()], shard=sh)
    ptr = p.data_ptr()
    fu.scatter_shard([p], torch.full((sh.row_len,), -1.0), spec, 1)
    assert p.data_ptr() == ptr and p.requires_grad
    np.testing.assert_array_equal(p.detach()[3:].numpy(), -1.0)
    np.testing.assert_array_equal(p.detach()[:3].numpy(),
                                  np.arange(12).reshape(3, 4))


def _host(t: torch.Tensor) -> np.ndarray:
    return fu.to_host(t)


def _jax_bytes(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("factor", [1, 2, 4])
@pytest.mark.parametrize("codec_spec", [None, "int8", "fp8", "topk:0.1"])
def test_pack_row_roundtrip_shard_x_codec_x_dtypes(factor, codec_spec):
    """Per-shard ``pack_row`` -> ``assemble_rows``: the port's rows and
    payloads are JAX's byte for byte; with no codec reassembly is exact,
    with one it equals assembling the decoded rows (the codec's own error
    is not under test)."""
    tt, jj = _leaves(10 + factor)
    spec, jspec = _specs(tt, jj, factor)
    codec, jcodec = cd.resolve(codec_spec), jcd.resolve(codec_spec)
    rows = [fu.pack_row([_host(t) for t in tt], spec, codec=codec, shard=s)
            for s in range(factor)]
    jrows = [jfu.pack_row(jj, jspec, codec=jcodec, shard=s)
             for s in range(factor)]
    for a, b in zip(rows, jrows):
        assert _jax_bytes(a) == _jax_bytes(b)
    back = fu.assemble_rows(rows, spec, codec=codec)
    jback = jfu.assemble_rows(jrows, jspec, codec=jcodec)
    for a, b in zip(back, jback):
        assert _jax_bytes(a) == _jax_bytes(b)
    if codec is None:
        for t, b in zip(tt, back):
            assert _jax_bytes(_host(t)) == _jax_bytes(b)
    else:
        raw = [codec.decode(r.reshape(-1).view(np.uint8), np.float32,
                            spec.shard.row_len) for r in rows]
        for a, b in zip(fu.assemble_rows(raw, spec), back):
            assert _jax_bytes(a) == _jax_bytes(b)


def test_shard_factor_1_wire_byte_identity():
    """A factor-1 sharded spec packs the unsharded row's exact bytes, with
    and without a codec."""
    tt, jj = _leaves(5)
    spec, _ = _specs(tt, jj, 1)
    assert spec.shard.totals == (spec.total,)
    assert spec.shard.row_len == spec.total
    host = [_host(t) for t in tt]
    assert fu.pack_row(host, spec).tobytes() == \
        fu.pack_row(host, spec, shard=0).tobytes()
    c = cd.Int8Codec()
    assert fu.pack_row(host, spec, codec=c).tobytes() == \
        fu.pack_row(host, spec, codec=c, shard=0).tobytes()
    assert torch.equal(fu.pack_shard(tt, spec, 0), fu.pack(tt, spec))
