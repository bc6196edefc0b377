"""The plain reference against the port at tiny widths on the CPU: equal to
rounding where the port computes in float32, and inside the tiny cells'
limits where it computes in bf16, as it does on the card."""

from __future__ import annotations

import pytest
import torch

from portbench import data, weights
from portbench.builders import load
from portbench.builders import lm as lm_builder
from portbench.builders import resnet as resnet_builder
from portbench.reference import lm, resnet
from portbench.tests.conftest import TINY_CELLS, TINY_CONFIGS

CPU = torch.device("cpu")


def _port_model(family: str, cfg: dict, dtype):
    from bluefog_tpu_torch.models import (BottleneckBlock, ResNet,
                                          TransformerLM, classification_loss,
                                          lm_loss)
    if family == "lm":
        model = TransformerLM(
            vocab_size=cfg["vocab_size"], num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"], d_model=cfg["hidden_size"],
            d_ff=cfg["intermediate_size"], dtype=dtype, device=CPU)
        return model, lm_loss, lm_builder.names(cfg)
    model = ResNet(stage_sizes=cfg["stage_sizes"], block_cls=BottleneckBlock,
                   num_classes=cfg["num_classes"], num_filters=cfg["num_filters"],
                   dtype=dtype, device=CPU)
    return model, classification_loss, resnet_builder.names(cfg)


@pytest.mark.parametrize("family,cell,ref", [
    ("lm", "tiny-lm.s32", lm), ("resnet", "tiny-resnet.b64", resnet)])
@pytest.mark.parametrize("seed", [0, 2 ** 40 + 17])
def test_float32_port_equals_the_reference(family, cell, ref, seed):
    config, job = TINY_CELLS[cell]
    cfg = TINY_CONFIGS[config]
    W = weights.generate(ref.param_specs(cfg), seed, CPU)
    batch = data.make(cfg, job, seed, CPU)[0]
    model, loss_fn, names = _port_model(family, cfg, torch.float32)
    load(model, W, names)
    loss = loss_fn(model, batch)
    loss.backward()
    leaves = {k: v.clone().requires_grad_() for k, v in W.items()}
    ref_loss = ref.loss(leaves, batch, cfg, "f32")
    ref_loss.backward()
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    # batch norm's backward over few values a channel carries float32
    # rounding of the two ways of computing it up to about 1e-3; a wrong
    # layer reads 1e-1 and more
    tol = 1e-4 if family == "lm" else 1e-2
    params = dict(model.named_parameters())
    for bench, prog in names.items():
        g, r = params[prog].grad, leaves[bench].grad
        assert float((g - r).norm()) <= tol * float(r.norm()) + 1e-7, bench


def test_param_specs_cover_every_port_parameter():
    for family, cell, ref in (("lm", "tiny-lm.s32", lm),
                              ("resnet", "tiny-resnet.b64", resnet)):
        cfg = TINY_CONFIGS[TINY_CELLS[cell][0]]
        model, _, names = _port_model(family, cfg, torch.float32)
        specs = {n: shape for n, shape, _ in ref.param_specs(cfg)}
        assert set(names) == set(specs)
        assert set(names.values()) == {n for n, _ in model.named_parameters()}
        params = dict(model.named_parameters())
        for bench, prog in names.items():
            assert tuple(params[prog].shape) == tuple(specs[bench]), bench


def test_weights_and_inputs_repeat_with_the_seed():
    cfg = TINY_CONFIGS["tiny-lm"]
    a = weights.generate(lm.param_specs(cfg), 2 ** 33 + 1, CPU)
    b = weights.generate(lm.param_specs(cfg), 2 ** 33 + 1, CPU)
    c = weights.generate(lm.param_specs(cfg), 2 ** 33 + 2, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    job = TINY_CELLS["tiny-lm.s32"][1]
    x = data.make(cfg, job, 5, CPU)
    assert torch.equal(x[0][0], data.make(cfg, job, 5, CPU)[0][0])
    assert torch.equal(x[0][0][:, 1:], x[0][1][:, :-1])
    rows = torch.cat([t for t, _ in x])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
