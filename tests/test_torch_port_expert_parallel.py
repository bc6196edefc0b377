"""Port vs JAX: expert parallelism (the all-to-all Switch dispatch).

The port runs as four gloo processes, each passing its quarter of the batch;
the JAX package runs the same global arrays on its 4-device CPU mesh
(``ep_mesh(4, cpu_devices(4))``). The cases follow
``tests/test_expert_parallel.py`` at E = 4 (one expert per rank):

  * ``ep_apply`` at capacity factor E (no drops), 2 and 1 (an expert's later
    tokens dropped): each rank's output against its rows of JAX's (1e-4,
    JAX's own tolerance for this pair), its aux against JAX's aux of that
    device (1e-5), and the same tokens dropped (rows exactly zero);
  * the zero gate (every token to expert 0): one token in four survives at
    factor 1, every token at E², where the output equals the dense oracle;
  * the gradients of ``sum(y * cot) + 0.1 * mean(aux)``: each rank's x
    rows, the replicated gate's full gradient (summed over the ranks), and
    row ``rank`` of ``up``/``down`` (its expert's, from every rank's
    tokens), each against ``jax.grad`` (1e-4); the other rows get nothing;
  * bf16 at a seed where both frameworks route every token alike (checked
    first), to 1e-2 of the largest output (measured 3.4e-3: the frameworks
    round bf16 intermediates at other places; f32 agrees to 1e-7);
  * the checks, raised on every rank: experts != ranks, unequal batches;
  * the MoE LM (E = 4, blocks 1 MoE, capacity factor E): ``ep_lm_apply``'s
    logits and aux, ``ep_lm_loss_fn``'s loss and every rank's gradient of
    every parameter against ``jax.grad`` of JAX's ``ep_lm_loss_fn`` (1e-4),
    the weights carried by ``params_from_jax(expert_rank=rank)``; a
    quarter of the replicated gradient, or n times an expert's, would
    miss; ``ep_lm_init`` and the seeded model against the dense twin; 30
    plain Adam steps that fall as JAX's test requires.

At world 1, in this process: ``chip_smoke.py``'s virtual expert group (the
port's local steps for four virtual ranks, lists transposed for each
all-to-all) against the dense oracle, with its drop count and planted fault.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bluefog_tpu_torch as bft
from bluefog_tpu import parallel as bfp
from bluefog_tpu.models import MoETransformerLM as JaxMoELM
from bluefog_tpu.parallel import expert as jax_expert
from bluefog_tpu_torch.parallel import expert as port_expert
from bluefog_tpu_torch.utils import params_from_jax
from conftest import cpu_devices
from _torch_port_child import run_world
from test_torch_port_slice import _flat, jax_to_dict, jax_tree_np

N = E = 4
B, S, D, D_FF = 8, 4, 16, 32
FACTORS = (float(E), 2.0, 1.0)
ZERO_FACTORS = (1.0, float(E * E))
CFG = dict(vocab=32, layers=2, heads=2, d_model=32, d_ff=64)
SEED = 0
STEPS = 30


def _bf16_routing(x, gate):
    """JAX's and the port's expert choice of each token in bf16."""
    xb = jnp.asarray(x, jnp.bfloat16).reshape(-1, D)
    jp = jax.nn.softmax((xb @ jnp.asarray(gate, jnp.bfloat16))
                        .astype(jnp.float32), axis=-1)
    _, _, _, _, best = port_expert.switch_send(
        torch.tensor(gate), torch.tensor(x).reshape(-1, D), E, 1,
        torch.bfloat16)
    return np.asarray(jnp.argmax(jp, -1)), best.numpy()


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    cot = rng.standard_normal((B, S, D)).astype(np.float32)
    switch = jax_expert.SwitchFFN(num_experts=E, d_ff=D_FF)
    params = jax_tree_np(jax.jit(switch.init)(jax.random.PRNGKey(1),
                                              x)["params"])
    lm = JaxMoELM(vocab_size=CFG["vocab"], num_experts=E,
                  num_layers=CFG["layers"], num_heads=CFG["heads"],
                  d_model=CFG["d_model"], d_ff=CFG["d_ff"], moe_every=2,
                  expert_axis="expert", capacity_factor=float(E))
    tokens = rng.integers(0, CFG["vocab"], (N, 16)).astype(np.int32)
    lm_params = jax_tree_np(jax.jit(lambda r, t: bfp.ep_lm_init(lm, r, t))(
        jax.random.PRNGKey(0), tokens))
    return x, cot, switch, params, lm, lm_params, tokens, \
        np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def port_run(setup, tmp_path_factory):
    x, cot, _, params, _, lm_params, tokens, targets = setup
    d = tmp_path_factory.mktemp("torch_port_expert")
    np.savez(d / "inputs.npz", x=x, cot=cot, tokens=tokens, targets=targets,
             capacity_factors=np.array(FACTORS),
             zero_gate_factors=np.array(ZERO_FACTORS),
             lm_capacity_factor=float(E), train_steps=STEPS, **CFG,
             **{f"sw:{k}": v for k, v in params.items()},
             **{f"lm:{k}": v for k, v in _flat(jax_to_dict(lm_params))
                .items()})
    return run_world("expert", str(d), world=N, timeout=240)


@pytest.fixture(scope="module")
def jax_run(setup):
    x, cot, switch, params, lm, lm_params, tokens, targets = setup
    mesh = jax_expert.ep_mesh(E, cpu_devices(E))
    out = {"oracle": switch.apply({"params": params}, x)}
    for cf in FACTORS:
        out[f"fwd_{cf}"], out[f"aux_{cf}"] = jax_expert.ep_apply(
            params, x, mesh, capacity_factor=cf)

        def loss(p, xx, cf=cf):
            y, aux = jax_expert.ep_apply(p, xx, mesh, capacity_factor=cf)
            return jnp.sum(y * cot) + 0.1 * aux.mean()

        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
        out[f"dx_{cf}"], out[f"dgate_{cf}"] = gx, gp["gate"]
        out[f"dup_{cf}"], out[f"ddown_{cf}"] = gp["up"], gp["down"]
    zero = dict(params, gate=np.zeros_like(params["gate"]))
    out["zero_oracle"] = switch.apply({"params": zero}, x)
    for cf in ZERO_FACTORS:
        out[f"zero_{cf}"], out[f"zero_aux_{cf}"] = jax_expert.ep_apply(
            zero, x, mesh, capacity_factor=cf)
    out["bf16"] = jax_expert.ep_apply(params, x, mesh,
                                      capacity_factor=float(E),
                                      dtype=jnp.bfloat16)[0]
    out["lm_logits"], out["lm_aux"] = bfp.ep_lm_apply(lm, lm_params, tokens,
                                                      mesh)
    loss, grads = jax.jit(jax.value_and_grad(bfp.ep_lm_loss_fn(lm, mesh)))(
        lm_params, (tokens, targets))
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    out["lm_loss"] = float(loss)
    out["lm_grads"] = jax_tree_np(grads)
    return out


def _rows(a, rank):
    b = a.shape[0] // N
    return a[rank * b:(rank + 1) * b]


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=msg)


@pytest.mark.parametrize("cf", FACTORS)
def test_ep_apply_matches_jax(cf, port_run, jax_run):
    """Each rank's output and aux against JAX's at this capacity factor;
    the dropped tokens (rows of zeros) are the same ones."""
    for rank in range(N):
        got, want = port_run[rank][f"fwd_{cf}"], _rows(jax_run[f"fwd_{cf}"],
                                                       rank)
        _close(got, want, 1e-4, f"rank {rank}")
        np.testing.assert_array_equal(np.abs(got).sum(-1) == 0,
                                      np.abs(want).sum(-1) == 0)
        _close(port_run[rank][f"aux_{cf}"], jax_run[f"aux_{cf}"][rank], 1e-5)
    if cf == float(E):
        _close(np.concatenate([port_run[r][f"fwd_{cf}"] for r in range(N)]),
               jax_run["oracle"], 1e-4)
    dropped = sum(int((np.abs(port_run[r][f"fwd_{cf}"]).sum(-1) == 0).sum())
                  for r in range(N))
    if cf == 1.0:
        assert dropped > 0


@pytest.mark.parametrize("cf", ZERO_FACTORS)
def test_ep_zero_gate_drops_and_survivors(cf, port_run, jax_run):
    """Every token to expert 0: at factor 1 each rank's capacity
    ceil(8 / 4) = 2 keeps its first two tokens (aux 1); at E² every token
    survives and the output is the dense oracle's."""
    for rank in range(N):
        got = port_run[rank][f"zero_{cf}"].reshape(-1, D)
        _close(got, _rows(jax_run[f"zero_{cf}"], rank).reshape(-1, D), 1e-4)
        _close(port_run[rank][f"zero_aux_{cf}"], 1.0, 1e-5)
        alive = np.flatnonzero(np.abs(got).sum(-1) > 0)
        if cf == 1.0:
            assert alive.tolist() == [0, 1], alive
        else:
            assert len(alive) == B // N * S
            _close(got, _rows(jax_run["zero_oracle"], rank).reshape(-1, D),
                   1e-4)


@pytest.mark.parametrize("cf", FACTORS)
def test_ep_apply_grads_match_jax(cf, port_run, jax_run):
    """x rows, the summed gate gradient and this rank's expert rows against
    ``jax.grad`` on every rank; nothing reaches the other experts' rows."""
    for rank in range(N):
        got = port_run[rank]
        _close(got[f"dx_{cf}"], _rows(jax_run[f"dx_{cf}"], rank), 1e-4)
        _close(got[f"dgate_{cf}"], jax_run[f"dgate_{cf}"], 1e-4)
        for w in ("up", "down"):
            _close(got[f"d{w}_{cf}"], jax_run[f"d{w}_{cf}"][rank], 1e-4,
                   f"rank {rank} {w}")
        assert got[f"flag:other_rows_{cf}"] == 1
    gate = jax_run[f"dgate_{cf}"]
    assert np.abs(gate / N - gate).max() > 1e-2


def test_ep_apply_bf16_matches_jax(setup, port_run, jax_run):
    x, _, _, params, *_ = setup
    jax_best, port_best = _bf16_routing(x, params["gate"])
    np.testing.assert_array_equal(jax_best, port_best)
    want = jax_run["bf16"]
    got = np.concatenate([port_run[r]["bf16"] for r in range(N)])
    _close(got, want, 1e-2 * np.abs(want).max())
    assert all(port_run[r]["flag:bf16_dtype"] == 1 for r in range(N))


@pytest.mark.parametrize("flag", ["bad_experts", "bad_batch",
                                  "lm_wrong_axis"])
def test_ep_checks_raise_on_every_rank(flag, port_run):
    assert [int(port_run[r][f"flag:{flag}"]) for r in range(N)] == [1] * N


def test_ep_lm_apply_matches_jax(port_run, jax_run):
    for rank in range(N):
        _close(port_run[rank]["lm_logits"], _rows(jax_run["lm_logits"], rank),
               1e-4)
        _close(port_run[rank]["lm_aux"], jax_run["lm_aux"], 1e-5)


@pytest.mark.parametrize("rank", range(N))
def test_ep_lm_loss_and_grads_match_jax(rank, port_run, jax_run):
    got = port_run[rank]
    _close(float(got["lm_loss"]), jax_run["lm_loss"], 1e-5)
    want = params_from_jax(jax_run["lm_grads"], expert_rank=rank)
    for name, g in want.items():
        _close(got[f"lm_grad:{name}"], g.numpy(), 1e-4, f"rank {rank} {name}")
    # a rank's share alone, or n times it, would miss
    head = want["lm_head.weight"].numpy()
    assert np.abs(head / N - head).max() > 1e-3


def test_ep_lm_init_and_training(port_run):
    """``ep_lm_init`` leaves each rank its slice of the dense twin's draw,
    which the seeded model already held; 30 Adam steps fall below 0.6 of
    the first loss on every rank (JAX's test), the replicated weights stay
    equal across the ranks and the experts differ."""
    for rank in range(N):
        got = port_run[rank]
        assert got["flag:lm_init_slice"] == 1
        assert got["flag:lm_seed_is_twin"] == 1
        losses = got["train_losses"]
        assert losses[-1] < 0.6 * losses[0], losses[::10]
        np.testing.assert_allclose(got["train_losses"],
                                   port_run[0]["train_losses"], rtol=1e-6)
        np.testing.assert_array_equal(got["train_head"],
                                      port_run[0]["train_head"])
    assert not np.allclose(port_run[0]["train_up"], port_run[1]["train_up"])


# ---------------------------------------------------------------------------
# world 1, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def world1():
    bft.init(device="cpu")
    yield
    bft.shutdown()


def test_virtual_expert_group_matches_dense(world1):
    """``chip_smoke.py``'s virtual group of four on the CPU in f32: at
    factor E the outputs and the gradients of x, gate, up and down equal
    the dense oracle's (1e-5); at factor 1 the kept tokens equal the
    oracle's, the dropped ones are exactly 0 and their count equals the
    count from the routing; the planted fault lands far beyond."""
    import chip_smoke

    res = chip_smoke.virtual_experts(torch, torch.device("cpu"), t=64, d=16,
                                     d_ff=32, n=E, dtype=torch.float32,
                                     drop_factor=1.0)
    assert max(res["errors"].values()) < 1e-5, res["errors"]
    drop = res["drops"]
    assert drop["kept_err"] < 1e-5 and drop["dropped_max"] == 0.0, drop
    assert drop["dropped"] == drop["expected"] > 0, drop
    assert min(res["planted"].values()) > 0.1, res["planted"]

