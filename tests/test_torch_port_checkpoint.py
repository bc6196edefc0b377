"""Port: checkpoint save/restore, held to ``tests/test_checkpoint.py``.

The JAX tests' six cases, in the port's form (one process per rank, the
state of an optimizer wrapper):

  * round trip with the momentum, and training on from the restored state;
  * ``save_async`` then ``wait_pending``, two in a row;
  * the world-identity sidecar, equal to JAX's ``_runtime_meta``;
  * a sidecar naming another world: a warning, or with ``strict=True`` a
    ``RuntimeError``;
  * no sidecar: restored without checks;
  * ``latest_path`` picks the newest directory by mtime.

At world 4 (gloo processes, ``tests/_torch_port_child.py``) every rank
trains towards its own target, so every rank's parameters and optimizer
state differ: every rank's state must come back exactly, under the
decentralized optimizer around SGD with momentum and under ZeRO-1 around
Adam (each rank's shard state). A bare DCP save of the same per-rank
tensors under one key shows the trap the rank keys avoid: DCP takes
equal keys for copies of one replicated tensor and keeps one.
"""

import json
import logging
import os
import time

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import checkpoint as ck
from conftest import cpu_devices
from _torch_port_child import run_world

N = 4
KINDS = ("sgd", "zero1")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_port_checkpoint")
    targets = np.arange(N, dtype=np.float32)[:, None] * \
        np.linspace(1.0, 2.0, 4, dtype=np.float32)
    np.savez(d / "inputs.npz", targets=targets)
    return d, run_world("checkpoint", str(d), world=N, timeout=240)


def _pick(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("kind", KINDS)
def test_roundtrip_every_rank_world4(kind, world4):
    """Every rank's parameters and optimizer state come back bit for bit,
    and one more step from the restored state equals the original's."""
    _, outs = world4
    for rank, out in enumerate(outs):
        assert int(out[f"{kind}:step"]) == 3
        orig = _pick(out, f"{kind}:orig:")
        rest = _pick(out, f"{kind}:rest:")
        assert sorted(orig) == sorted(rest) and len(orig) >= 3, sorted(rest)
        for name, want in orig.items():
            np.testing.assert_array_equal(rest[name], want,
                                          err_msg=f"rank {rank} {name}")
        for name, want in _pick(out, f"{kind}:cont_orig:").items():
            np.testing.assert_array_equal(out[f"{kind}:cont_rest:{name}"],
                                          want, err_msg=f"rank {rank} {name}")
    # the ranks' saved states differ: four distinct states came back
    for name, v in _pick(outs[0], f"{kind}:orig:").items():
        if name.startswith("s") and not name.endswith("_step"):
            assert not np.array_equal(v, outs[1][f"{kind}:orig:{name}"])


def test_async_save_roundtrip_world4(world4):
    """The state at each ``save_async`` call is what lands, though the
    steps after it change it; two saves in a row both commit."""
    _, outs = world4
    for rank, out in enumerate(outs):
        for key, step in (("a1", 5), ("a2", 6)):
            assert int(out[f"{key}:step"]) == step
            want = _pick(out, f"{key}:want:")
            assert len(want) >= 3
            for name, v in want.items():
                np.testing.assert_array_equal(out[f"{key}:got:{name}"], v,
                                              err_msg=f"rank {rank} {key}")
        assert not np.array_equal(out["a1:want:p_w"], out["a2:want:p_w"])


def test_bare_dcp_keeps_one_replica_world4(world4):
    """The trap: under one key, the four ranks' different tensors come back
    as one rank's, so three ranks lose their own (the rank keys above keep
    every one)."""
    _, outs = world4
    got = [float(out["naive_w"][0]) for out in outs]
    assert len(set(got)) == 1
    assert sum(g != r for r, g in enumerate(got)) == N - 1


def test_meta_sidecar_matches_jax_world4(world4):
    """The sidecar holds JAX's ``_runtime_meta`` fields and values for the
    same world and topology (Expo-2 over 4). ``process_count`` counts the
    port's processes, one per rank, where JAX's single controller counts
    one; ``membership_epoch`` waits for the port's heartbeat."""
    from bluefog_tpu import checkpoint as jck

    d, _ = world4
    with open(d / "sgd.bf_meta.json") as f:
        meta = json.load(f)
    bf.init(devices=cpu_devices(N))
    try:
        want = jck._runtime_meta(3)
    finally:
        bf.shutdown()
    want.pop("membership_epoch", None)
    assert want["process_count"] == 1
    assert meta == dict(want, process_count=N)
    assert ck.read_meta(str(d / "sgd")) == meta


# ---------------------------------------------------------------------------
# world 1, in this process
# ---------------------------------------------------------------------------

class _Leaves(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(4))


def _loss(model, b):
    return 0.5 * ((model.w - b) ** 2).sum()


def _opt():
    model = _Leaves()
    return bft.DistributedNeighborAllreduceOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), model,
        _loss)


@pytest.fixture
def world1():
    bft.init(device="cpu")
    yield
    bft.shutdown()


def test_checkpoint_roundtrip(world1, tmp_path):
    opt = _opt()
    for _ in range(3):
        opt.step(torch.arange(4.0))
    path = ck.save(str(tmp_path / "ckpt"), opt, step=3)
    restored, step = ck.restore(path, _opt())
    assert step == 3
    assert torch.equal(restored.model.w, opt.model.w)
    (mom,) = (s["momentum_buffer"] for s in opt.base.state.values())
    (got,) = (s["momentum_buffer"] for s in restored.base.state.values())
    assert torch.equal(got, mom)
    restored.step(torch.arange(4.0))
    opt.step(torch.arange(4.0))
    assert torch.equal(restored.model.w, opt.model.w)


def test_async_save_roundtrip(world1, tmp_path):
    opt = _opt()
    opt.step(torch.ones(4))
    want = opt.model.w.detach().clone()
    ck.save_async(str(tmp_path / "a1"), opt, step=5)
    with torch.no_grad():
        opt.model.w.add_(1.0)
    ck.save_async(str(tmp_path / "a2"), opt, step=6)
    ck.wait_pending()
    for name, step, w in (("a1", 5, want), ("a2", 6, want + 1.0)):
        restored, got = ck.restore(str(tmp_path / name), _opt())
        assert got == step
        assert torch.equal(restored.model.w, w)


def test_meta_sidecar_records_world_identity(world1, tmp_path):
    path = str(tmp_path / "meta_ck")
    ck.save(path, _opt(), step=4)
    meta = ck.read_meta(path)
    assert meta["world"] == 1 and meta["step"] == 4
    assert meta["process_count"] == 1 and "topology_crc" in meta
    _, step = ck.restore(path, _opt(), strict=True)
    assert step == 4


def test_meta_mismatch_warns_and_strict_raises(world1, tmp_path):
    path = str(tmp_path / "mismatch_ck")
    ck.save(path, _opt(), step=1)
    meta = ck.read_meta(path)
    meta["world"] = 16
    meta["topology_crc"] = (meta["topology_crc"] + 1) & 0xFFFFFFFF
    with open(ck._meta_path(path), "w") as f:
        json.dump(meta, f)
    # the package logger sets propagate=False, as the JAX package's does
    # (tests/test_checkpoint.py): capture with our own handler
    records = []
    cap = logging.Handler(level=logging.WARNING)
    cap.emit = records.append
    ck.logger.addHandler(cap)
    try:
        ck.restore(path, _opt())
    finally:
        ck.logger.removeHandler(cap)
    assert any("different world" in r.getMessage() for r in records)
    with pytest.raises(RuntimeError, match="different world"):
        ck.restore(path, _opt(), strict=True)


def test_meta_absent_is_tolerated(world1, tmp_path):
    path = str(tmp_path / "old_ck")
    ck.save(path, _opt(), step=2)
    os.unlink(ck._meta_path(path))
    assert ck.read_meta(path) is None
    _, step = ck.restore(path, _opt(), strict=True)
    assert step == 2


def test_save_without_force_refuses_an_existing_path(world1, tmp_path):
    path = str(tmp_path / "ck")
    ck.save(path, _opt(), step=1)
    with pytest.raises(FileExistsError):
        ck.save(path, _opt(), step=2, force=False)
    ck.save(path, _opt(), step=2)
    assert ck.restore(path, _opt())[1] == 2


def test_checkpoint_needs_init(tmp_path):
    import types

    model = _Leaves()
    opt = types.SimpleNamespace(model=model, base=torch.optim.SGD(
        model.parameters(), lr=0.1))
    for call in (ck.save, ck.save_async):
        with pytest.raises(RuntimeError, match="bf.init"):
            call(str(tmp_path / "ck"), opt, step=0)


def test_latest_path_picks_newest(tmp_path):
    assert ck.latest_path(str(tmp_path)) is None
    for name in ("ck1", "ck2", "ck3"):
        os.mkdir(tmp_path / name)
        time.sleep(0.01)
    os.utime(tmp_path / "ck2")  # freshest mtime
    assert ck.latest_path(str(tmp_path)) == str(tmp_path / "ck2")
    assert ck.latest_path(str(tmp_path / "missing")) is None
