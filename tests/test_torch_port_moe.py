"""Port vs JAX: the Switch mixture of experts, dense mode (CPU).

``SwitchFFN`` against flax's ``SwitchFFN(expert_axis=None)`` and the MoE
``TransformerLM`` against flax's ``MoETransformerLM`` (vocab 64, E 8, 2
layers, 2 heads, d 32, d_ff 64: the sizes of
``tests/test_expert_parallel.py``), weights carried across with
``params_from_jax``. In f32 the outputs, the logits and every gradient
agree to 1e-5, and ``load_balance_loss`` to 1e-6. In bf16 a token whose two
best experts nearly tie can go to another expert in flax than in the port
(the frameworks round bf16 intermediates at different places), so the bf16
forward is compared at seeds where both route every token alike (checked
first), to 2e-2 of the largest logit as the dense LM's bf16 test.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bluefog_tpu.models import MoETransformerLM as JaxMoELM
from bluefog_tpu.parallel import expert as jax_expert
from bluefog_tpu_torch.models import MoEBlock, MoETransformerLM, TransformerLM
from bluefog_tpu_torch.models.transformer import Block
from bluefog_tpu_torch.parallel import SwitchFFN, load_balance_loss
from bluefog_tpu_torch.utils import params_from_jax

E = 8
CFG = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@lru_cache(maxsize=None)
def _switch(shape):
    d, d_ff = 16, 32
    jm = jax_expert.SwitchFFN(num_experts=E, d_ff=d_ff)
    x = np.random.default_rng(3).standard_normal(shape + (d,)).astype(
        np.float32)
    params = jm.init(jax.random.PRNGKey(1), x)["params"]
    return jm, params, x


@pytest.mark.parametrize("shape", [(8, 4), (24,)], ids=["BSd", "Td"])
def test_switch_ffn_output_and_grads_match_flax(shape):
    jm, params, x = _switch(shape)
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * cot)

    want = np.asarray(jm.apply({"params": params}, x))
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, x)
    tm = SwitchFFN(16, E, 32, device="cpu")
    tm.load_state_dict(params_from_jax(_np(params)), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-5)
    for name in ("gate", "up", "down"):
        np.testing.assert_allclose(getattr(tm, name).grad.numpy(),
                                   np.asarray(jg[name]), rtol=0, atol=1e-5,
                                   err_msg=name)
    # every expert carried tokens: each gradient term was exercised
    _, best = tm.route(xt.detach())
    assert len(set(best.flatten().tolist())) > E // 2


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 6, E)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    best = probs.argmax(-1)
    want = float(jax_expert.load_balance_loss(probs, best, E))
    got = float(load_balance_loss(torch.tensor(probs), torch.tensor(best),
                                  E))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # all tokens on one expert with uniform probabilities: E * 1 * 1/E = 1
    uniform = torch.full((10, E), 1.0 / E)
    np.testing.assert_allclose(float(load_balance_loss(
        uniform, torch.zeros(10, dtype=torch.long), E)), 1.0, rtol=1e-6)


@lru_cache(maxsize=None)
def _lm(dtype_name: str, seed: int):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
    jm = JaxMoELM(num_experts=E, moe_every=2, dtype=jdt, **CFG)
    toks = np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (2, 24)).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(seed), toks)["params"]
    tm = MoETransformerLM(num_experts=E, moe_every=2, dtype=tdt,
                          device="cpu", **CFG)
    tm.load_state_dict(params_from_jax(_np(params)), strict=True)
    return jm, params, tm, toks


def test_moe_lm_places_blocks_as_flax():
    tm = MoETransformerLM(num_experts=4, num_layers=6, moe_every=3,
                          device="cpu", **{k: v for k, v in CFG.items()
                                           if k != "num_layers"})
    kinds = [type(getattr(tm, f"block_{i}")) for i in range(6)]
    assert kinds == [Block, Block, MoEBlock, Block, Block, MoEBlock]
    names = [n for n, _ in tm.block_2.named_children()]
    assert names == ["RMSNorm_0", "qkv", "out", "RMSNorm_1", "moe"]


def test_moe_tree_loads_strictly_and_gives_flax_logits():
    """``block_1/moe/{up,down}`` are raw leaves, carried untransposed
    (d 32 != d_ff 64, so a transpose could not load)."""
    jm, params, tm, toks = _lm("f32", 0)
    sd = params_from_jax(_np(params))
    assert tuple(sd["block_1.moe.up"].shape) == (E, 32, 64)
    assert tuple(sd["block_1.moe.down"].shape) == (E, 64, 32)
    assert tuple(sd["block_0.up.weight"].shape) == (64, 32)
    missing, unexpected = tm.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    want = np.asarray(jm.apply({"params": params}, toks))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_moe_lm_loss_grads_match_flax():
    jm, params, tm, toks = _lm("f32", 0)
    tgts = np.roll(toks, -1, axis=1)

    def jloss(p):
        logits = jm.apply({"params": p}, toks)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, tgts[..., None], -1))

    jl, jg = jax.value_and_grad(jloss)(params)
    tm.zero_grad(set_to_none=True)
    logits = tm(torch.from_numpy(toks).long())
    tl = torch.nn.functional.cross_entropy(
        logits.reshape(-1, CFG["vocab_size"]),
        torch.from_numpy(tgts).long().reshape(-1))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=1e-5)
    want = params_from_jax(_np(jg))
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def _flax_routing(jm, params, toks) -> np.ndarray:
    """flax's expert choice in block_1: its router on the MoE block's
    normed input (``RMSNorm_1``'s output, captured)."""
    _, inter = jm.apply({"params": params}, toks, capture_intermediates=True)
    h = inter["intermediates"]["block_1"]["RMSNorm_1"]["__call__"][0]
    gate = params["block_1"]["moe"]["gate"].astype(h.dtype)
    probs = jax.nn.softmax((h @ gate).astype(jnp.float32), axis=-1)
    return np.asarray(jnp.argmax(probs, axis=-1))


def _port_routing(tm, toks) -> np.ndarray:
    seen = []
    hook = tm.block_1.moe.register_forward_pre_hook(
        lambda mod, args: seen.append(mod.route(args[0])[1]))
    with torch.no_grad():
        tm(torch.from_numpy(toks).long())
    hook.remove()
    return seen[0].numpy()


@pytest.mark.parametrize("seed", [0, 5])
def test_moe_lm_bf16_forward_matches_flax(seed):
    """At these seeds every token goes to the same expert in both (seed 3
    sends 1 of 48 elsewhere: two bf16 router logits tie)."""
    jm, params, tm, toks = _lm("bf16", seed)
    routed_apart = (_port_routing(tm, toks)
                    != _flax_routing(jm, params, toks)).mean()
    assert routed_apart == 0.0
    want = np.asarray(jm.apply({"params": params}, toks))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_expert_init_uses_flax_fan_in():
    """gate and up draw with fan-in d, down with fan-in d_ff (flax's
    lecun_normal reads the second-to-last axis); none left uninitialised."""
    tm = MoETransformerLM(vocab_size=64, num_experts=4, num_layers=2,
                          num_heads=2, d_model=64, d_ff=256, device="cpu",
                          seed=7)
    moe = tm.block_1.moe
    for w, fan_in in ((moe.gate, 64), (moe.up, 64), (moe.down, 256)):
        assert torch.isfinite(w).all()
        assert abs(float(w.detach().std()) * fan_in ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("build", ["SwitchFFN", "TransformerLM"])
def test_expert_axis_is_not_ported_yet(build):
    """The expert-parallel mode (``tests/test_torch_port_expert_parallel.py``)
    holds one expert per rank of its group: it needs ``bf.init()`` first,
    and 4 experts over a world of one raise."""
    import bluefog_tpu_torch as bft

    def make():
        if build == "SwitchFFN":
            return SwitchFFN(16, 4, 32, expert_axis="expert", device="cpu")
        return TransformerLM(num_experts=4, expert_axis="expert",
                             device="cpu", **CFG)

    with pytest.raises(RuntimeError, match="bf.init"):
        make()
    bft.init(device="cpu")
    try:
        with pytest.raises(ValueError, match="one expert per rank"):
            make()
    finally:
        bft.shutdown()


def test_params_from_jax_keeps_raw_leaves_to_switch_ffns():
    """A raw ``up``/``down`` leaf maps only inside ``moe`` (or a bare
    SwitchFFN tree); elsewhere it is unmapped and raises."""
    with pytest.raises(KeyError, match="block_0/up"):
        params_from_jax({"block_0": {"up": np.zeros((2, 3))}})
    with pytest.raises(KeyError, match="router"):
        params_from_jax({"block_1": {"moe": {"router": np.zeros((2, 3))}}})
