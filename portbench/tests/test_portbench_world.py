"""A cell of two ranks on the CPU (gloo), launched as the card's ranks are:
rank 0's line holds both ranks' work, the program's combine agrees with
the reference's written-out neighbour mean, and a combine that leaves out
the exchange is not correct."""

from __future__ import annotations

import pytest

from portbench import harness, world

CELL = "tiny-lm.s32.x2"


def test_two_ranks_agree_with_the_reference(tiny_root):
    result, timing = world.launch(CELL, 2 ** 33 + 5, 0.5, True, 2,
                                  device="cpu", root=tiny_root)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] % 2 == 0 and result["attempted"] > 0
    assert result["failed"] == 0
    assert result["metrics"]["update_ms.lm"]["value"] >= 0
    assert 0 < timing["setup_s"] and 0 < timing["window_s"]


@pytest.mark.parametrize("fault", harness.WORLD_FAULTS)
def test_a_combine_without_the_exchange_is_not_correct(tiny_root, fault):
    result, _ = world.launch(CELL, 2 ** 33 + 7, 0.3, False, 2, device="cpu",
                             root=tiny_root, faults=(fault,))
    assert result["correct"] is False, result["checks"]
