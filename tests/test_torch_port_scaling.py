"""Port vs JAX: the scaling evidence.

``bluefog_tpu_torch/scaling.py`` records the port's production train steps
as one rank of a fake world of 8-128 ranks (torch's ``fake`` backend, in
this process, on the CPU) and counts the ``c10d`` ops they dispatch;
``bluefog_tpu/scaling.py`` lowers JAX's step programs over abstract meshes
of the same sizes and counts the StableHLO collectives. Both run here, in
process, as ``tests/test_scaling.py`` runs JAX's. With one leaf the counts
and the bytes handed to the collectives agree on every kind; with more
leaves the port's rounds stay put (one flat buffer) where JAX's permutes
grow per leaf, which ``test_per_leaf_divergence`` pins.
"""

import math
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bluefog_tpu import scaling as jscaling
from bluefog_tpu_torch import scaling
from bluefog_tpu_torch.runtime.state import _global_state

NS = (8, 16, 64, 128)
_FIVE = ("collective_permute", "all_reduce", "all_gather", "reduce_scatter",
         "all_to_all")


def _jax_counts(kind, n, **kw):
    c = jscaling.count_step_collectives(kind, n, **kw)
    return {k: c[k] for k in _FIVE}


def _port(kind, n, rank=scaling.RECORD_RANK, **kw):
    return scaling.record_train_step(kind, n, rank=rank, device="cpu", **kw)


@pytest.mark.parametrize("n", NS)
def test_plans_equal_jax(n):
    """Static Expo-2 and every step of the one-peer cycle: the weight
    arrays and shifts bit for bit; the neighbor optimizer, given the
    one-peer arguments, builds the same matrix."""
    for mine, theirs in [(scaling.static_expo2_plan(n),
                          jscaling.static_expo2_plan(n))] + [
            (scaling.dynamic_onepeer_plan(n, step),
             jscaling.dynamic_onepeer_plan(n, step))
            for step in range(math.ceil(math.log2(n)))]:
        assert mine.shifts == tuple(theirs.shifts)
        assert mine.use_gather == theirs.use_gather
        np.testing.assert_array_equal(mine.weight_array(),
                                      np.asarray(theirs.weight_array()))
        np.testing.assert_array_equal(mine.W, np.asarray(theirs.W))
    with scaling.fake_world(n, 3, "cpu", local_size=n):
        model = torch.nn.Linear(4, 4)
        for step in (0, 1):
            opt = scaling.train_step_optimizer(
                "neighbor_dynamic_onepeer",
                torch.optim.SGD(model.parameters(), lr=0.1), model,
                lambda m, b: m(b).sum(), step=step)
            np.testing.assert_array_equal(
                opt._plan().W, scaling.dynamic_onepeer_plan(n, step).W)
            assert len(opt._plan().shifts) == 1


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kind", scaling.KINDS)
def test_step_counts_equal_jax(kind, n):
    """Each kind's recorded step against JAX's lowered one: the same count
    of each collective class, no shape check, and the groups the JAX test
    reads off the replica groups (hierarchical: the all-reduce over
    ``local_size`` ranks, the rounds over the machine group)."""
    rec = _port(kind, n)
    got = scaling.collective_counts(rec)
    assert {k: got[k] for k in _FIVE} == _jax_counts(kind, n)
    assert got["negotiate"] == 0
    if kind.startswith("neighbor"):
        assert got["all_reduce"] == 0
    if kind == "neighbor_static_expo2":
        assert got["collective_permute"] == math.ceil(math.log2(n))
    if kind == "neighbor_dynamic_onepeer":
        assert got["collective_permute"] == 1
    if kind == "zero1":
        assert got["reduce_scatter"] == got["all_gather"] == 1
    sizes = {(c.cls, c.group_size) for c in rec}
    if kind == "hierarchical":
        m = n // 4
        assert sizes == {("all_reduce", 4), ("collective_permute", m),
                         ("recv", m)}
        assert got["collective_permute"] == math.ceil(math.log2(m))
    else:
        assert {s for _, s in sizes} == {n}


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kind", scaling.KINDS)
def test_step_bytes_equal_jax(kind, n):
    """The bytes each rank hands to each class equal JAX's operand bytes
    (one 64x64 f32 leaf = 16384 B a round for the neighbor kinds)."""
    got = scaling.collective_bytes(_port(kind, n))
    want = jscaling.collective_bytes(jscaling.lower_train_step(kind, n))
    assert got == {k: want[k] for k in _FIVE}
    if kind == "neighbor_dynamic_onepeer":
        assert got["collective_permute"] == 64 * 64 * 4
    if kind == "neighbor_static_expo2":
        assert got["collective_permute"] == \
            math.ceil(math.log2(n)) * 64 * 64 * 4


@pytest.mark.parametrize("n", NS)
def test_counts_same_at_every_rank(n):
    for kind in scaling.KINDS:
        want = scaling.collective_counts(_port(kind, n))
        for rank in (0, 3, n - 1):
            assert scaling.collective_counts(_port(kind, n, rank)) == want, \
                (kind, rank)


def test_per_leaf_divergence():
    """Three leaves: JAX's StableHLO holds 3x the permutes of one leaf; the
    port packs the leaves into one buffer, so it takes the rounds of one
    leaf with 3x the bytes."""
    n = 8
    one = _port("neighbor_static_expo2", n, n_leaves=1)
    three = _port("neighbor_static_expo2", n, n_leaves=3)
    assert scaling.collective_counts(three) == scaling.collective_counts(one)
    assert scaling.collective_counts(three)["collective_permute"] == 3
    assert scaling.collective_bytes(three)["collective_permute"] == \
        3 * scaling.collective_bytes(one)["collective_permute"]
    assert _jax_counts("neighbor_static_expo2", n, n_leaves=3)[
        "collective_permute"] == 9


@pytest.mark.parametrize("n", NS)
def test_wire_bytes_model_equals_jax(n):
    for kind in scaling.KINDS:
        for p in (scaling.RESNET50_BYTES, 1_342_251_008):
            assert scaling.wire_bytes_per_chip(kind, n, p) == \
                jscaling.wire_bytes_per_chip(kind, n, p)
    assert scaling.KINDS == jscaling.KINDS
    assert scaling.RESNET50_BYTES == jscaling.RESNET50_BYTES


@pytest.mark.parametrize("n", NS)
def test_ring_forward_two_hops_per_step(n):
    """JAX's scan body: two permutes, each one [B, S/n, H, D] bf16 block;
    the port's ring: two sends per ring step, with the same bytes."""
    S, H, D = 1024, 8, 64
    rec, steps = scaling.record_cp_forward(n, seq=S, heads=H, d_head=D,
                                           device="cpu")
    got = scaling.collective_counts(rec)
    assert steps == n - 1
    assert got["collective_permute"] == 2 * steps
    assert got["all_reduce"] == got["negotiate"] == 0
    per_step = scaling.collective_bytes(rec)["collective_permute"] // steps
    txt = jscaling.lower_cp_forward(n, seq=S, heads=H, d_head=D)
    assert jscaling.collective_counts(txt)["collective_permute"] == 2
    assert per_step == jscaling.collective_bytes(txt)[
        "collective_permute"] == 2 * (S // n) * H * D * 2


_MOE_BASE = {}


@pytest.mark.parametrize("n", NS)
def test_moe_lm_grad_constant_all_to_all(n):
    """4 all_to_all per MoE layer at every n, no P2P round, no
    reduce-scatter; each chip's all_to_all payload equals JAX's and stays
    within its 0.8-1.25x band of n = 8's."""
    rec = scaling.record_moe_lm_grad(n, rank=n - 1, device="cpu")
    got = scaling.collective_counts(rec)
    assert got["all_to_all"] == 4, got
    assert got["collective_permute"] == got["reduce_scatter"] == 0
    assert got["all_gather"] == 0
    assert got["negotiate"] == 2   # the batch check: sizes, then pickles
    payload = scaling.collective_bytes(rec)["all_to_all"]
    want = jscaling.collective_bytes(jscaling.lower_moe_lm_grad(n))
    assert payload == want["all_to_all"]
    base = _MOE_BASE.setdefault(
        "b", scaling.collective_bytes(scaling.record_moe_lm_grad(
            8, device="cpu"))["all_to_all"])
    assert 0.8 * base <= payload <= 1.25 * base


def test_moe_lm_grad_all_to_all_scales_per_layer():
    rec = scaling.record_moe_lm_grad(8, moe_every=1, device="cpu")
    assert scaling.collective_counts(rec)["all_to_all"] == 8


def test_fake_world_always_tears_down():
    with pytest.raises(ZeroDivisionError):
        with scaling.fake_world(16, 2, "cpu"):
            assert dist.get_world_size() == 16 and dist.get_rank() == 2
            1 / 0
    assert not dist.is_initialized()
    assert not _global_state().initialized


def test_scaling_torch_md_is_current(tmp_path):
    out = tmp_path / "SCALING_TORCH.md"
    scaling.write_scaling_md(str(out), device="cpu")
    committed = (pathlib.Path(__file__).parent.parent /
                 "SCALING_TORCH.md").read_text()
    assert out.read_text() == committed
