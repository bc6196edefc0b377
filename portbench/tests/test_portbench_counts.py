"""The frozen FLOP and byte arithmetic against counts made by hand at each
cell's shapes."""

from __future__ import annotations

import pytest

from portbench.counts import flash, lm, resnet
from portbench.counts.peaks import H100_BF16_FLOPS, H100_HBM_BYTES
from portbench.spec import Spec

PYTHIA = dict(hidden_size=2048, intermediate_size=8192, num_hidden_layers=24,
              vocab_size=50304)


def test_pythia_matmul_parameters():
    # per layer: qkv 3 * 2048^2 + out 2048^2 + up and down 2 * 2048 * 8192
    per_layer = 12_582_912 + 4_194_304 + 33_554_432
    assert lm.matmul_params(PYTHIA) == 24 * per_layer + 50304 * 2048
    assert lm.matmul_params(PYTHIA) == 1_310_982_144


@pytest.mark.parametrize("batch,seq,expected", [
    # 6 * 1,310,982,144 * 16,384 + 12 * 24 * B * S^2 * 2048 / 2
    (2, 8192, 128_874_788_683_776 + 39_582_418_599_936),
    (8, 2048, 128_874_788_683_776 + 9_895_604_649_984),
])
def test_pythia_step_flops(batch, seq, expected):
    assert lm.step_flops(PYTHIA, batch, seq) == expected


def test_resnet50_forward_macs():
    cfg = dict(image_size=224, num_filters=64, stage_sizes=[3, 4, 6, 3],
               num_classes=1000)
    # stem 112^2 * 64 * 3 * 49; stage 1 (56^2): 3 blocks of 64->64 1x1,
    # 3x3, 64->256 1x1, one projection 64->256; the later stages halve the
    # map at their first block's 3x3; the classifier 2048 x 1000
    stem = 112 * 112 * 64 * 3 * 49
    s1 = 56 * 56 * (64 * 64 + 64 * 64 * 9 + 64 * 256) * 3 \
        + 56 * 56 * (256 * 64 - 64 * 64) * 2 + 56 * 56 * 64 * 256
    assert resnet.forward_macs(cfg) == 4_089_184_256
    assert stem == 118_013_952 and s1 > 0
    assert resnet.step_flops(cfg, 256) == 3 * 2 * 4_089_184_256 * 256


def test_flash_bounds_at_the_s8192_shape():
    B, S, H, D = 2, 8192, 16, 128
    pairs = B * H * S * (S + 1) // 2
    assert pairs == 1_073_872_896
    b = flash.kernel_bounds(B, S, H, D)
    assert b["flash_fwd"] == pytest.approx(2 * 2 * pairs * D / H100_BF16_FLOPS)
    assert b["flash_bwd_dq"] == pytest.approx(3 * 2 * pairs * D / H100_BF16_FLOPS)
    assert b["flash_bwd_dkv"] == pytest.approx(4 * 2 * pairs * D / H100_BF16_FLOPS)
    # every one of them is bound by its operations, not its bytes
    assert 3 * B * S * H * D * 2 / H100_HBM_BYTES < b["flash_fwd"]


def test_cells_shapes_are_the_counted_ones():
    spec = Spec()
    for name in spec.cell_names:
        cell = spec.cell(name)
        if cell.config["builder"] == "lm":
            assert cell.config["hidden_size"] // cell.config[
                "num_attention_heads"] == 128
            assert lm.matmul_params(cell.config) == 1_310_982_144
