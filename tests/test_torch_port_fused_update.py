"""The fused Adam/AdamW update (``bluefog_tpu_torch/ops/update.py``), on the
CPU, where ``adam`` runs its plain version.

* Against ``torch.optim.Adam`` and ``AdamW``: an optimizer with
  ``FusedAdamStep`` installed and an untouched twin, fed the same gradients
  for 5 steps, hold the same parameters, ``exp_avg``, ``exp_avg_sq`` and
  ``step`` (to 1e-6 of each tensor's largest magnitude) under weight decay 0
  and 0.01, two param groups with different ``lr``, an ``lr`` changed
  between steps as a scheduler changes it, and a parameter without a
  gradient in one step.
* The dispatch, through ``DistributedNeighborAllreduceOptimizer`` and ZeRO-1
  at world 1: it engages for ``Adam`` and ``AdamW`` (``opt.update_fused``
  grows by the parameters' count) and falls back to torch's step, untouched,
  for SGD, a subclass of ``Adam``, ``amsgrad``, ``maximize``, ``fused`` and
  bf16 parameters (``opt.update_fused`` grows by 0); a second wrapper of
  one optimizer shares the first's installation; a ``step`` replaced on the
  instance, as the benchmark's planted fault replaces it, runs instead.
* The state: after fused steps, ``state_dict`` loads into a plain ``Adam``
  that continues bit for bit with the fused one; an LR scheduler made before
  or after the wrapper keeps setting the rate, without its warning; an
  optimizer dropped is freed at once (no reference cycle through its
  ``step``).
"""

import copy
import warnings

import pytest
import torch

import bluefog_tpu_torch as bft
from bluefog_tpu_torch.ops import update
from bluefog_tpu_torch.runtime import metrics

STEPS = 5
SHAPES = [(7, 5), (13,), (4, 3, 2)]


def _params(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return [torch.nn.Parameter(torch.randn(s, generator=g).to(dtype))
            for s in SHAPES]


def _grads(step: int, dtype=torch.float32):
    g = torch.Generator().manual_seed(100 + step)
    return [torch.randn(s, generator=g).to(dtype) for s in SHAPES]


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= 1e-6 * scale, (err, scale)


CASES = {
    "wd0": dict(groups=lambda ps: ps, kw=dict(weight_decay=0.0)),
    "wd0.01": dict(groups=lambda ps: ps, kw=dict(weight_decay=0.01)),
    "two_groups": dict(groups=lambda ps: [{"params": ps[:2]},
                                          {"params": ps[2:], "lr": 3e-3}],
                       kw=dict(weight_decay=0.01)),
    "lr_changed": dict(groups=lambda ps: ps, kw={}, lr_at={2: 5e-3, 4: 2e-3}),
    "grad_none": dict(groups=lambda ps: ps, kw={}, none_at={1: 1, 3: 0}),
}


def _train(cls, case: str, fused: bool):
    spec = CASES[case]
    ps = _params()
    opt = cls(spec["groups"](ps), lr=1e-2, **spec["kw"])
    installed = update.FusedAdamStep.install(opt) if fused else None
    for step in range(STEPS):
        for group in opt.param_groups:
            if step in spec.get("lr_at", {}):
                group["lr"] = spec["lr_at"][step]
        for i, (p, g) in enumerate(zip(ps, _grads(step))):
            p.grad = None if spec.get("none_at", {}).get(step) == i else g
        opt.step()
        if installed is not None:
            live = sum(p.numel() for p in ps if p.grad is not None)
            assert installed.updated == live
    return ps, opt


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("cls", [torch.optim.Adam, torch.optim.AdamW])
def test_plain_version_against_torch(cls, case):
    got_ps, got = _train(cls, case, fused=True)
    want_ps, want = _train(cls, case, fused=False)
    assert update.launch_counts["adam"] == 0      # the CPU launches nothing
    for a, b in zip(got_ps, want_ps):
        _close(a.detach(), b.detach())
        sa, sb = got.state[a], want.state[b]
        assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
        assert sa["step"].device.type == "cpu"
        assert sa["step"].dtype == sb["step"].dtype
        assert float(sa["step"]) == float(sb["step"])
        _close(sa["exp_avg"], sb["exp_avg"])
        _close(sa["exp_avg_sq"], sb["exp_avg_sq"])


# ---------------------------------------------------------------------------
# the dispatch under the distributed optimizers, at world 1
# ---------------------------------------------------------------------------

@pytest.fixture()
def world1(tmp_path, monkeypatch):
    monkeypatch.setenv("BFT_FLIGHT_DIR", str(tmp_path))
    bft.init(device="cpu")
    yield
    bft.shutdown()


class _SubAdam(torch.optim.Adam):
    pass


ENGAGE = {
    "adam": lambda ps: torch.optim.Adam(ps, lr=1e-2),
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-2, weight_decay=0.01),
}
FALL_BACK = {
    "sgd": (lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9), None),
    "adam_subclass": (lambda ps: _SubAdam(ps, lr=1e-2), None),
    "amsgrad": (lambda ps: torch.optim.Adam(ps, lr=1e-2, amsgrad=True), None),
    "maximize": (lambda ps: torch.optim.Adam(ps, lr=1e-2, maximize=True),
                 None),
    "fused": (lambda ps: torch.optim.Adam(ps, lr=1e-2, fused=True), None),
    "bf16": (lambda ps: torch.optim.Adam(ps, lr=1e-2), torch.bfloat16),
}


def _loss(model, batch):
    return sum((p.float() * x).sum() for p, x in zip(model.parameters(),
                                                      batch))


class _Model(torch.nn.Module):
    def __init__(self, ps):
        super().__init__()
        self.ps = torch.nn.ParameterList(ps)


def _wrapped(kind: str, make, dtype=torch.float32):
    """``kind`` around ``make``'s optimizer, and an untouched twin of it."""
    ps, twin_ps = _params(dtype), _params(dtype)
    opt = getattr(bft, kind)(make(ps), _Model(ps), _loss)
    return opt, ps, make(twin_ps), twin_ps


def _run(opt, twin, twin_ps, steps: int = 3):
    """Steps of ``opt`` and its twin on the same batches; the growth of
    ``opt.update_fused``."""
    before = metrics.counter("opt.update_fused").value
    for step in range(steps):
        batch = _grads(step)
        opt.step([b.to(twin_ps[0].dtype) for b in batch])
        twin.zero_grad(set_to_none=True)
        _loss(_Model(twin_ps), [b.to(twin_ps[0].dtype) for b in batch]
              ).backward()
        twin.step()
    return metrics.counter("opt.update_fused").value - before


@pytest.mark.parametrize("kind", ["DistributedNeighborAllreduceOptimizer",
                                  "DistributedShardedAllreduceOptimizer"])
@pytest.mark.parametrize("name", list(ENGAGE))
def test_dispatch_engages(world1, name, kind):
    opt, ps, twin, twin_ps = _wrapped(kind, ENGAGE[name])
    grew = _run(opt, twin, twin_ps)
    assert grew == 3 * sum(p.numel() for p in ps)
    for a, b in zip(ps, twin_ps):
        _close(a.detach(), b.detach())


@pytest.mark.parametrize("name", list(FALL_BACK))
def test_dispatch_falls_back(world1, name):
    make, dtype = FALL_BACK[name]
    opt, ps, twin, twin_ps = _wrapped(
        "DistributedNeighborAllreduceOptimizer", make,
        dtype or torch.float32)
    assert _run(opt, twin, twin_ps) == 0
    for a, b in zip(ps, twin_ps):
        assert torch.equal(a.detach(), b.detach())


def test_a_second_wrapper_shares_the_installation(world1):
    ps = _params()
    adam = torch.optim.Adam(ps, lr=1e-2)
    first = bft.DistributedNeighborAllreduceOptimizer(adam, _Model(ps), _loss)
    second = bft.DistributedAllreduceOptimizer(adam, _Model(ps), _loss)
    assert first._fused is second._fused is not None
    before = metrics.counter("opt.update_fused").value
    second.step(_grads(0))
    assert metrics.counter("opt.update_fused").value - before == \
        sum(p.numel() for p in ps)


def test_a_step_replaced_on_the_instance_runs_instead(world1):
    opt, ps, twin, twin_ps = _wrapped("DistributedNeighborAllreduceOptimizer",
                                      ENGAGE["adam"])
    _run(opt, twin, twin_ps, steps=1)
    before = [p.detach().clone() for p in ps]
    opt.base.step = lambda *a, **k: None        # a state left unchanged
    assert _run(opt, twin, twin_ps, steps=1) == 0
    assert all(torch.equal(a, b.detach()) for a, b in zip(before, ps))


# ---------------------------------------------------------------------------
# the state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [torch.optim.Adam, torch.optim.AdamW])
def test_state_dict_continues_bit_for_bit(cls):
    ps = _params()
    opt = cls(ps, lr=1e-2, weight_decay=0.01)
    fused = update.FusedAdamStep.install(opt)
    for step in range(2):
        for p, g in zip(ps, _grads(step)):
            p.grad = g
        opt.step()
    assert fused.updated == sum(p.numel() for p in ps)
    twin = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    plain = cls(twin, lr=1e-2, weight_decay=0.01)
    plain.load_state_dict(copy.deepcopy(opt.state_dict()))
    for step in range(2, STEPS):
        for p, q, g in zip(ps, twin, _grads(step)):
            p.grad, q.grad = g, g.clone()
        opt.step()
        plain.step()
        assert fused.updated == sum(p.numel() for p in ps)
    for p, q in zip(ps, twin):
        assert torch.equal(p, q)
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], plain.state[q][key])


@pytest.mark.parametrize("order", ["scheduler_first", "wrapper_first"])
def test_lr_scheduler_keeps_setting_the_rate(world1, order):
    ps, twin_ps = _params(), _params()
    adam, twin = torch.optim.Adam(ps, lr=1e-2), torch.optim.Adam(twin_ps,
                                                                 lr=1e-2)
    scheds = [torch.optim.lr_scheduler.StepLR(twin, step_size=1, gamma=0.5)]
    if order == "scheduler_first":
        scheds.append(torch.optim.lr_scheduler.StepLR(adam, 1, gamma=0.5))
    opt = bft.DistributedNeighborAllreduceOptimizer(adam, _Model(ps), _loss)
    if order == "wrapper_first":
        scheds.append(torch.optim.lr_scheduler.StepLR(adam, 1, gamma=0.5))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for _ in range(3):
            assert _run(opt, twin, twin_ps, steps=1) == \
                sum(p.numel() for p in ps)
            for s in scheds:
                s.step()
    assert adam.param_groups[0]["lr"] == twin.param_groups[0]["lr"] == \
        1e-2 / 8
    for a, b in zip(ps, twin_ps):
        _close(a.detach(), b.detach())


def test_adam_refuses_tensors_off_the_cpu_and_cuda():
    ts = [torch.zeros(4, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        update.adam(*[[t] for t in ts], step=1.0, lr=1e-3,
                    betas=(0.9, 0.999), eps=1e-8)


def test_an_optimizer_dropped_is_freed_without_the_collector():
    import gc
    import weakref

    ps = _params()
    opt = torch.optim.Adam(ps, lr=1e-2)
    assert update.FusedAdamStep.install(opt) is not None
    for p, g in zip(ps, _grads(0)):
        p.grad = g
    opt.step()
    gone = weakref.ref(opt)
    gc.disable()
    try:
        del opt
        assert gone() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# the chip smoke's count of the kernel on its training paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, make, dtype, want", [
    ("adam", ENGAGE["adam"], torch.float32, 1),
    ("adamw", ENGAGE["adamw"], torch.float32, 1),
    ("sgd", FALL_BACK["sgd"][0], torch.float32, 0),
    ("bf16", ENGAGE["adam"], torch.bfloat16, 0),
])
def test_chip_smoke_expects_the_kernel_where_it_runs(world1, name, make,
                                                     dtype, want):
    """``chip_smoke.py`` lists the kernel among the port's own, and expects
    of a wrapped optimizer one launch a step per 64 f32 tensors with a
    gradient where the dispatch engages, none where torch's step runs."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    assert set(update.launch_counts) <= set(chip_smoke.OWN_KERNELS)
    src, why = chip_smoke.OWN_KERNELS["adam"]
    assert os.path.isfile(os.path.join(repo, src)) and why.startswith("none")
    opt, ps, twin, twin_ps = _wrapped("DistributedNeighborAllreduceOptimizer",
                                      make, dtype)
    grew = _run(opt, twin, twin_ps, steps=1)
    assert chip_smoke._adam_per_step(torch, opt) == want
    assert (grew > 0) == (want > 0)
    assert chip_smoke._adam_per_step(torch, chip_smoke._plain_adam(
        _Model(twin_ps), _loss)) == 0
