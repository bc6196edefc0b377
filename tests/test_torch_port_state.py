"""Port vs JAX: what ``init`` takes from the environment.

``BFT_SKIP_NEGOTIATE`` sets the negotiate stage's skip flag at every
``init`` as ``BLUEFOG_SKIP_NEGOTIATE`` does in the JAX package
(``bluefog_tpu/runtime/state.py:241``): on, off, and a re-init without it
clears a flag the last one set. ``BFT_SIMULATE_DEVICES`` (what ``bfrun
--simulate N`` exports) makes ``init`` without a device take the CPU, and
raise when this host's ranks are not N, as JAX raises when it has fewer
CPU devices than it was told to simulate; an explicit device wins over it,
and without it the default stays the card.
"""

import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from conftest import cpu_devices


def _jax_flag() -> bool:
    bf.init(devices=cpu_devices(1))
    try:
        return bf.get_skip_negotiate_stage()
    finally:
        bf.shutdown()


def _port_flag() -> bool:
    bft.init(device="cpu")
    try:
        return bft.get_skip_negotiate_stage()
    finally:
        bft.shutdown()


@pytest.mark.parametrize("value", ["1", "0", None])
def test_skip_negotiate_knob_against_jax(value, monkeypatch):
    for name in ("BLUEFOG_SKIP_NEGOTIATE", "BFT_SKIP_NEGOTIATE"):
        monkeypatch.delenv(name, raising=False)
    # a flag set by hand, then an init under the knob's value
    bf.init(devices=cpu_devices(1))
    bf.set_skip_negotiate_stage(True)
    bf.shutdown()
    bft.init(device="cpu")
    bft.set_skip_negotiate_stage(True)
    bft.shutdown()
    if value is not None:
        monkeypatch.setenv("BLUEFOG_SKIP_NEGOTIATE", value)
        monkeypatch.setenv("BFT_SKIP_NEGOTIATE", value)
    want = _jax_flag()
    assert want is (value == "1")
    assert _port_flag() is want


def test_skip_negotiate_reinit_clears(monkeypatch):
    monkeypatch.setenv("BFT_SKIP_NEGOTIATE", "1")
    monkeypatch.setenv("BLUEFOG_SKIP_NEGOTIATE", "1")
    assert _port_flag() and _jax_flag()
    monkeypatch.delenv("BFT_SKIP_NEGOTIATE")
    monkeypatch.delenv("BLUEFOG_SKIP_NEGOTIATE")
    assert not _port_flag() and not _jax_flag()


def _clear_launch_env(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK", "LOCAL_WORLD_SIZE", "BFT_CP_HOST",
                 "BFT_CP_PORT", "BFT_CP_HOSTS"):
        monkeypatch.delenv(name, raising=False)


def test_simulate_takes_the_cpu(monkeypatch):
    _clear_launch_env(monkeypatch)
    monkeypatch.setenv("BFT_SIMULATE_DEVICES", "1")
    bft.init()
    try:
        assert bft.runtime.state._global_state().device.type == "cpu"
        assert torch.distributed.get_backend() == "gloo"
        assert bft.size() == 1
    finally:
        bft.shutdown()


def test_simulate_world_mismatch_raises(monkeypatch):
    _clear_launch_env(monkeypatch)
    monkeypatch.setenv("BFT_SIMULATE_DEVICES", "4")
    with pytest.raises(RuntimeError, match="BFT_SIMULATE_DEVICES=4 but "
                       "this host runs 1 rank"):
        bft.init()
    assert not torch.distributed.is_initialized()
    assert not bft.runtime.state._global_state().initialized


def test_explicit_device_wins_and_default_stays_the_card(monkeypatch):
    _clear_launch_env(monkeypatch)
    monkeypatch.setenv("BFT_SIMULATE_DEVICES", "4")
    if not torch.cuda.is_available():
        # an explicit device is the caller's: simulate does not apply
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bft.init(device="cuda")
    bft.init(device="cpu")      # no world check for an explicit device
    bft.shutdown()
    monkeypatch.delenv("BFT_SIMULATE_DEVICES")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bft.init()
    assert not torch.distributed.is_initialized()
