"""Port vs JAX: ring and Ulysses context parallelism, ``cp_apply`` and
``cp_loss_fn``.

The port runs as four gloo processes, each passing its sequence shard
``[B, S/4, H, D]``; the JAX package runs the same global arrays on its
4-device CPU mesh (``mesh_1d(4, "rank")``), the Pallas flash kernel in
interpret mode. The cases follow ``tests/test_parallel.py``,
``tests/test_transformer_cp.py`` and the ring tests of ``tests/test_flash.py``:

  * the einsum ring and the flash ring (on the CPU, the kernels' plain
    versions), causal on and off: each rank's output against its rows of
    JAX's ``ring_attention`` to 2e-5 (f32), and its q/k/v gradients of
    ``sum(out * g)`` against ``jax.grad`` of it to 2e-5;
  * Ulysses, forward and gradients, the same way;
  * Sq != Sk (cross attention lengths) and bf16 (3e-2, the output in bf16);
  * the shape checks: one rank with a shorter shard makes every rank
    raise, and Ulysses refuses heads that n does not divide;
  * ``cp_apply`` against JAX's ``cp_apply`` (2e-4);
  * ``cp_loss_fn``'s loss (1e-5 relative) and every parameter gradient
    (atol 1e-4, rtol 1e-3) against JAX's DENSE loss and gradients, as
    ``test_transformer_cp.py`` checks JAX's own (its CP-gradient test is
    ``slow``): a rank left with the gradient of its own quarter of the
    sequence would miss by the other three quarters.

In this process, at world 1: the ring as a ``TransformerLM`` ``attn_fn``
against the flash model; the n = 1 ring issues no transfer; the port's
own step functions driven as a virtual ring of four (``chip_smoke.py``'s
phase, on the CPU) against dense attention, with its planted faults.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bluefog_tpu_torch as bft
from bluefog_tpu import parallel as bfp
from bluefog_tpu.models.transformer import TransformerLM
from bluefog_tpu.parallel.context import mesh_1d
from conftest import cpu_devices
from _torch_port_child import run_world
from test_torch_port_slice import _flat, _port_name, jax_to_dict

N = 4
B, S, H, D = 2, 32, 8, 16
CFG = dict(vocab=64, layers=2, heads=8, d_model=64, d_ff=128)
CAUSAL = (0, 1)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    arr = {x: rng.standard_normal((B, S, H, D)).astype(np.float32)
           for x in "qkvg"}
    arr["qx"] = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    arr["kx"], arr["vx"] = (rng.standard_normal((2, 64, 4, 8))
                            .astype(np.float32) for _ in range(2))
    model = TransformerLM(vocab_size=CFG["vocab"], num_layers=CFG["layers"],
                          num_heads=CFG["heads"], d_model=CFG["d_model"],
                          d_ff=CFG["d_ff"])
    tokens = rng.integers(0, CFG["vocab"], (2, S)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(2), tokens)["params"]
    return arr, model, params, tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def port_run(setup, tmp_path_factory):
    arr, _, params, tokens, targets = setup
    d = tmp_path_factory.mktemp("torch_port_context")
    np.savez(d / "inputs.npz", tokens=tokens, targets=targets, **arr, **CFG,
             **{f"p:{k}": v for k, v in _flat(jax_to_dict(params)).items()})
    return run_world("context", str(d), world=N, timeout=240)


def _grads(fn, q, k, v, g):
    def loss(a, b, c):
        return jnp.sum(fn(a, b, c) * g)
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.fixture(scope="module")
def jax_run(setup):
    arr, model, params, tokens, targets = setup
    mesh = mesh_1d(N, "rank", devices=cpu_devices(N))
    q, k, v, g = (arr[x] for x in "qkvg")
    out = {}
    for causal in CAUSAL:
        for kind, flash in (("einsum", False), ("flash", True)):
            fn = partial(bfp.ring_attention, mesh=mesh, causal=bool(causal),
                         use_flash=flash, interpret=flash)
            out[f"ring_{kind}_{causal}"] = fn(q, k, v)
            out.update(zip([f"ring_{kind}_{causal}_d{x}" for x in "qkv"],
                           _grads(fn, q, k, v, g)))
        fn = partial(bfp.ulysses_attention, mesh=mesh, causal=bool(causal))
        out[f"ulysses_{causal}"] = fn(q, k, v)
        out.update(zip([f"ulysses_{causal}_d{x}" for x in "qkv"],
                       _grads(fn, q, k, v, g)))
    bq, bk, bv = (jnp.asarray(arr[x], jnp.bfloat16) for x in "qkv")
    for kind, flash in (("einsum", False), ("flash", True)):
        out[f"cross_{kind}"] = bfp.ring_attention(
            arr["qx"], arr["kx"], arr["vx"], mesh=mesh, use_flash=flash,
            interpret=flash)
        out[f"bf16_{kind}"] = bfp.ring_attention(
            bq, bk, bv, mesh=mesh, causal=True, use_flash=flash,
            interpret=flash).astype(jnp.float32)
    variables = {"params": params}
    for kind in ("ring", "ulysses"):
        out[f"cp_apply_{kind}"] = bfp.cp_apply(model, variables, tokens,
                                               mesh=mesh, kind=kind)

    def dense_loss(p):
        logits = model.apply({"params": p}, tokens)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, targets[..., None], axis=-1).mean()

    loss, grads = jax.value_and_grad(dense_loss)(params)
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    out["dense_loss"] = float(loss)
    out["dense_grads"] = _flat(jax_to_dict(jax.tree_util.tree_map(
        np.asarray, grads)))
    return out


def _rows(a, rank):
    s = a.shape[1] // N
    return a[:, rank * s:(rank + 1) * s]


RING_KEYS = [f"ring_{kind}_{c}" for c in CAUSAL for kind in ("einsum",
                                                             "flash")]


@pytest.mark.parametrize("key", RING_KEYS + [f"ulysses_{c}" for c in CAUSAL])
def test_port_attention_matches_jax(key, port_run, jax_run):
    """Every rank's output and q/k/v gradients against JAX's (2e-5)."""
    for rank in range(N):
        for suffix in ("", "_dq", "_dk", "_dv"):
            np.testing.assert_allclose(
                port_run[rank][key + suffix],
                _rows(jax_run[key + suffix], rank), atol=2e-5, rtol=2e-5,
                err_msg=f"rank {rank} {key}{suffix}")


@pytest.mark.parametrize("kind", ["einsum", "flash"])
def test_port_ring_cross_lengths_and_bf16(kind, port_run, jax_run):
    """Sq != Sk (non-causal, 4 of 16 q rows against 16 of 64 keys per rank)
    to 2e-5; the causal bf16 ring to 3e-2, its output in bf16."""
    for rank in range(N):
        np.testing.assert_allclose(
            port_run[rank][f"cross_{kind}"],
            _rows(jax_run[f"cross_{kind}"], rank), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(
            port_run[rank][f"bf16_{kind}"],
            _rows(jax_run[f"bf16_{kind}"], rank), atol=3e-2, rtol=3e-2)
        assert port_run[rank][f"flag:bf16_{kind}_dtype"] == 1


@pytest.mark.parametrize("flag", ["bad_seq_ring", "bad_seq_ulysses",
                                  "bad_heads_ulysses"])
def test_port_cp_shape_checks(flag, port_run):
    """JAX ``_cp_call``'s ``ValueError``s, raised on every rank."""
    assert [int(port_run[r][f"flag:{flag}"]) for r in range(N)] == [1] * N


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_port_cp_apply_matches_jax(kind, port_run, jax_run):
    for rank in range(N):
        np.testing.assert_allclose(
            port_run[rank][f"cp_apply_{kind}"],
            _rows(jax_run[f"cp_apply_{kind}"], rank), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_port_cp_loss_and_grads_match_jax_dense(kind, port_run, jax_run):
    """Every rank's loss and full-sequence gradient equal JAX's dense
    model's; each rank's share alone would not."""
    for rank in range(N):
        got = port_run[rank]
        np.testing.assert_allclose(float(got[f"cp_loss_{kind}"]),
                                   jax_run["dense_loss"], rtol=1e-5)
        for key, want in jax_run["dense_grads"].items():
            g = got[f"cp_grad_{kind}:{_port_name(key)}"]
            if key.endswith("kernel"):
                g = g.T
            np.testing.assert_allclose(g, want, atol=1e-4, rtol=1e-3,
                                       err_msg=f"rank {rank} {key}")
    # the test can see a partial gradient: a quarter of lm_head's differs
    head = jax_run["dense_grads"]["lm_head/kernel"]
    assert np.abs(head / N - head).max() > 1e-2


# ---------------------------------------------------------------------------
# world 1, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def world1():
    bft.init(device="cpu")
    yield
    bft.shutdown()


def test_ring_is_an_attn_fn(world1):
    """``partial(ring_attention_shard, causal=True, use_flash=True)`` in a
    ``TransformerLM`` at world 1 gives the flash model's logits and
    gradients exactly: one K1 call at (0, 0) and one K2/K3 pass."""
    from bluefog_tpu_torch.parallel import (flash_attention,
                                            ring_attention_shard)

    toks = torch.randint(0, 64, (2, 32), generator=torch.Generator()
                         .manual_seed(3))
    models = [bft.models.TransformerLM(
        vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
        attn_fn=fn, device="cpu", seed=1) for fn in (
            partial(ring_attention_shard, causal=True, use_flash=True),
            flash_attention)]
    losses = []
    for m in models:
        loss = bft.models.lm_loss(m, (toks, toks.roll(-1, 1)))
        loss.backward()
        losses.append(loss.detach())
    assert torch.equal(*losses)
    for a, b in zip(*(m.parameters() for m in models)):
        assert torch.equal(a.grad, b.grad)


def test_ring_at_world_one_issues_no_transfer(world1, monkeypatch):
    import torch.distributed as dist

    def refuse(*a, **kw):
        raise AssertionError("a transfer at n = 1")

    monkeypatch.setattr(dist, "batch_isend_irecv", refuse)
    monkeypatch.setattr(dist, "all_to_all_single", refuse)
    monkeypatch.setattr(dist, "all_reduce", refuse)
    q, k, v = (torch.randn(1, 16, 4, 8, requires_grad=True)
               for _ in range(3))
    for use_flash in (False, True):
        bft.parallel.ring_attention_shard(q, k, v, causal=True,
                                          use_flash=use_flash).sum().backward()
    bft.parallel.ulysses_attention_shard(q, k, v, causal=True).sum().backward()
    m = bft.models.TransformerLM(vocab_size=32, num_layers=1, num_heads=4,
                                 d_model=32, d_ff=64, device="cpu")
    toks = torch.zeros((1, 16), dtype=torch.long)
    bft.parallel.cp_loss_fn(m)(m, (toks, toks)).backward()


def test_cp_needs_init():
    q = torch.zeros(1, 8, 4, 8)
    with pytest.raises(RuntimeError, match="bf.init"):
        bft.parallel.ring_attention_shard(q, q, q)
    with pytest.raises(RuntimeError, match="bf.init"):
        bft.parallel.ulysses_attention(q, q, q)


@pytest.mark.parametrize("use_flash", [False, True])
def test_virtual_ring_matches_dense(use_flash):
    """``chip_smoke.py``'s virtual ring (the port's step functions in
    lock-step for four ranks, lists rolled for the rotation) on the CPU at
    a small size: outputs and dq/dk/dv against dense attention to 2e-5,
    K1/K2/K3 called n^2 times on the flash path, and both planted faults
    far beyond."""
    import chip_smoke

    gen = torch.Generator().manual_seed(9)
    q, k, v, g = (torch.randn((1, 64, 2, 16), generator=gen)
                  for _ in range(4))
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = bft.parallel.reference_attention(qq, kk, vv, causal=True)
    want.backward(g)
    calls = {"fwd": 0, "bwd": 0}
    ctx = bft.parallel.context
    real_f, real_b = ctx.flash_block, ctx.flash_block_bwd

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    ctx.flash_block = count("fwd", real_f)
    ctx.flash_block_bwd = count("bwd", real_b)
    try:
        runs = {f: chip_smoke.virtual_ring(q, k, v, g, N, use_flash, fault=f)
                for f in (None,) + chip_smoke.RING_FAULTS}
    finally:
        ctx.flash_block, ctx.flash_block_bwd = real_f, real_b
    good = runs[None]
    for got, ref in zip(good, (want, qq.grad, kk.grad, vv.grad)):
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                                   atol=2e-5, rtol=2e-5)
    if use_flash:
        per_run = N * N
        assert calls == {"fwd": per_run * 3, "bwd": per_run * 3}
    for fault in chip_smoke.RING_FAULTS:
        out = runs[fault][0]
        assert float((out - want.detach()).abs().max()) > 0.1, fault
