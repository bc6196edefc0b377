"""The optimizer update: a hand-written fused Adam/AdamW kernel and its plain
twin.

Replaces no Pallas kernel: the JAX package steps ``optax.adam`` inside its
jitted training step, where XLA fuses the update into one loop over the
state. The port's ``torch.optim.Adam`` on CUDA runs torch's foreach chain
instead, about eight passes over the state (72-84 B a parameter), which made
the update of a 1.41 B-parameter LM 36.5 ms, three times its bound. The
kernel (``parallel/csrc/adam.cu``) is one pass: each element reads p, g, m
and v and writes p, m and v once, 28 B a parameter, so its bound is the
card's bandwidth (11.8 ms for 1.41 B parameters at 3.35 TB/s). One launch
covers up to 64 tensors through a table of pointers passed as a kernel
argument; its arithmetic is the foreach chain's, rounding for rounding.

  * :func:`adam` updates lists of tensors that share hyper-parameters and a
    step count. It takes the plain version (:func:`adam_plain`, torch's own
    per-tensor step) only when the tensors lie on the CPU (the tests); on
    CUDA tensors it launches the kernel or raises. ``launch_counts`` counts
    its launches, one per launch and nowhere else.
  * :class:`FusedAdamStep` makes a ``torch.optim.Adam`` or ``AdamW``'s own
    ``step`` run :func:`adam` whenever that reproduces torch's step exactly,
    and torch's step otherwise. The distributed optimizers install it on
    their base optimizer, so whoever calls ``base.step()`` runs it.
"""

from __future__ import annotations

import ctypes
import types
import weakref
from typing import Dict, List, Optional, Sequence

import torch
from torch.optim import optimizer as _torch_optimizer

from ..parallel import _build

launch_counts: Dict[str, int] = {"adam": 0}
TENSORS_PER_LAUNCH = 64     # the kernel's table (csrc/adam.cu, kMaxTensors)

_U64 = ctypes.c_uint64
_F = ctypes.c_float
# group options under which torch's step is not the one :func:`adam` computes
_OFF = ("amsgrad", "maximize", "capturable", "differentiable", "fused")
_STATE = {"step", "exp_avg", "exp_avg_sq"}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _fn():
    fn = _build.load("adam").bft_adam
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [_F] * 7
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def adam_plain(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               exp_avgs: Sequence[torch.Tensor],
               exp_avg_sqs: Sequence[torch.Tensor], *, step: float,
               lr: float, betas, eps: float, weight_decay: float = 0.0,
               decoupled: bool = False) -> None:
    """The plain version: ``torch.optim.Adam``'s per-tensor step, in place,
    for tensors at step count ``step`` (already incremented)."""
    beta1, beta2 = betas
    step_size = lr / (1 - beta1 ** step)
    bc2_sqrt = (1 - beta2 ** step) ** 0.5
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        if weight_decay != 0:
            if decoupled:
                p.mul_(1 - lr * weight_decay)
            else:
                g = g.add(p, alpha=weight_decay)
        m.lerp_(g, 1 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
        p.addcdiv_(m, (v.sqrt() / bc2_sqrt).add_(eps), value=-step_size)


def adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
         exp_avgs: Sequence[torch.Tensor], exp_avg_sqs: Sequence[torch.Tensor],
         *, step: float, lr: float, betas, eps: float,
         weight_decay: float = 0.0, decoupled: bool = False) -> None:
    """One Adam (``decoupled=False``) or AdamW step of every tensor, in
    place: ``params``, ``exp_avgs`` and ``exp_avg_sqs`` are updated from
    ``grads``. All are contiguous float32, on the CPU or on one CUDA device;
    ``step`` is the step count after this step's increment."""
    tensors = [*params, *grads, *exp_avgs, *exp_avg_sqs]
    if len(tensors) != 4 * len(params):
        raise ValueError("adam takes as many grads and moments as params")
    devices = {t.device for t in tensors}
    if {d.type for d in devices} == {"cpu"}:
        return adam_plain(params, grads, exp_avgs, exp_avg_sqs, step=step,
                          lr=lr, betas=betas, eps=eps,
                          weight_decay=weight_decay, decoupled=decoupled)
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"adam's tensors must all lie on the CPU or on one "
                         f"CUDA device, got {sorted(map(str, devices))}")
    for name, ts in (("params", params), ("grads", grads),
                     ("exp_avgs", exp_avgs), ("exp_avg_sqs", exp_avg_sqs)):
        for t in ts:
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise TypeError(f"adam's {name} must be contiguous float32, "
                                f"got {t.dtype} of stride {t.stride()}")
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"adam: shapes differ: {p.shape}, {g.shape}, "
                             f"{m.shape}, {v.shape}")
    beta1, beta2 = betas
    mode, decay = 0, 0.0
    if weight_decay != 0:
        mode, decay = (2, 1 - lr * weight_decay) if decoupled else \
            (1, weight_decay)
    k = len(params)
    ptrs = [(_U64 * k)(*(t.data_ptr() for t in ts))
            for ts in (params, grads, exp_avgs, exp_avg_sqs)]
    n = (ctypes.c_int64 * k)(*(p.numel() for p in params))
    launches = ctypes.c_int(0)
    stream = torch.cuda.current_stream(params[0].device).cuda_stream
    err = _fn()(*ptrs, n, k, 1 - beta1, beta2, 1 - beta2,
                (1 - beta2 ** step) ** 0.5, eps, -(lr / (1 - beta1 ** step)),
                decay, mode, stream, ctypes.byref(launches))
    if err:
        raise RuntimeError(f"CUDA kernel bft_adam failed to launch: "
                           f"cudaError {err}")
    launch_counts["adam"] += launches.value
    torch.autograd.graph.increment_version([*params, *exp_avgs, *exp_avg_sqs])


def _plain_f32(t: torch.Tensor) -> bool:
    return (type(t) in (torch.Tensor, torch.nn.Parameter)
            and t.dtype == torch.float32 and t.layout == torch.strided
            and t.is_contiguous() and t.device.type in ("cpu", "cuda"))


def _fused_groups(opt: torch.optim.Optimizer) -> Optional[list]:
    """``[(group, params with a gradient)]`` when :func:`adam` computes
    ``opt``'s next step exactly as torch would, else None. Reads only."""
    if (opt._optimizer_step_pre_hooks or opt._optimizer_step_post_hooks
            or _torch_optimizer._global_optimizer_pre_hooks
            or _torch_optimizer._global_optimizer_post_hooks):
        return None
    out, devices = [], set()
    for group in opt.param_groups:
        if any(group.get(key) for key in _OFF):
            return None
        hyper = (group["lr"], *group["betas"], group["eps"],
                 group["weight_decay"])
        if any(isinstance(x, torch.Tensor) for x in hyper):
            return None
        live = [p for p in group["params"] if p.grad is not None]
        for p in live:
            state = opt.state.get(p)
            tensors = [p, p.grad]
            if state:
                step = state.get("step")
                if (set(state) != _STATE or not isinstance(step, torch.Tensor)
                        or step.device.type != "cpu" or step.numel() != 1):
                    return None
                tensors += [state["exp_avg"], state["exp_avg_sq"]]
            if not all(_plain_f32(t) for t in tensors):
                return None
            devices.update(t.device for t in tensors)
        out.append((group, live))
    if len(devices) > 1:
        return None
    # on CUDA, torch's per-tensor step (foreach=False) rounds otherwise, and
    # torch refuses a graph capture without capturable
    if devices and next(iter(devices)).type == "cuda" and (
            any(group.get("foreach") is False for group, _ in out)
            or torch.cuda.is_current_stream_capturing()):
        return None
    return out


def _fused_step(opt: torch.optim.Optimizer, groups: list) -> int:
    """``opt``'s step through :func:`adam`, its state created lazily as
    torch creates it; the number of elements updated."""
    decoupled = type(opt) is torch.optim.AdamW
    updated = 0
    with torch.no_grad():
        for group, live in groups:
            for p in live:
                state = opt.state[p]
                if not state:
                    state["step"] = torch.tensor(
                        0.0, dtype=_torch_optimizer._get_scalar_dtype())
                    state["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            steps = [opt.state[p]["step"] for p in live]
            if not steps:
                continue
            torch._foreach_add_(steps, 1)
            by_step: Dict[float, List[torch.Tensor]] = {}
            for p, t in zip(live, steps):
                by_step.setdefault(t.item(), []).append(p)
            for step, ps in by_step.items():
                adam(ps, [p.grad for p in ps],
                     [opt.state[p]["exp_avg"] for p in ps],
                     [opt.state[p]["exp_avg_sq"] for p in ps], step=step,
                     lr=group["lr"], betas=group["betas"], eps=group["eps"],
                     weight_decay=group["weight_decay"],
                     decoupled=group.get("decoupled_weight_decay", decoupled))
                updated += sum(p.numel() for p in ps)
    return updated


class FusedAdamStep:
    """Runs a ``torch.optim.Adam`` or ``AdamW``'s ``step`` through
    :func:`adam` whenever that is exactly torch's step: no closure, no step
    hooks, every group without ``amsgrad``, ``maximize``, ``capturable``,
    ``differentiable`` and ``fused``, float hyper-parameters, and every
    parameter with a gradient a contiguous float32 tensor with a contiguous
    float32 gradient and state, all on one device. Otherwise torch's own
    step runs. The state is the optimizer's own (``exp_avg``,
    ``exp_avg_sq``, a CPU ``step``), so ``state_dict`` and the checkpoints
    see what torch's step leaves.

    ``updated``: the elements the last step updated through :func:`adam`;
    0 when torch's step ran. The caller resets it before a step whose
    ``step`` may have been replaced."""

    def __init__(self, opt: torch.optim.Optimizer, prior) -> None:
        self.updated = 0
        self._opt = weakref.ref(opt)
        self._prior = prior

    @classmethod
    def install(cls, opt: torch.optim.Optimizer) -> Optional["FusedAdamStep"]:
        """Install on ``opt`` as its ``step`` (or the installation ``opt``
        has); None, and ``opt`` left alone, unless ``opt`` is exactly an
        ``Adam`` or ``AdamW`` whose ``step`` is its class's or an LR
        scheduler's wrapper of it.

        The ``step`` is a method, as a scheduler made later wraps it (it
        calls the function bound to ``opt``), bound to this object, which
        holds ``opt`` weakly: an optimizer that held itself through its own
        attribute would keep its state on the card until the garbage
        collector ran."""
        if type(opt) not in (torch.optim.Adam, torch.optim.AdamW):
            return None
        prior = vars(opt).get("step")
        if isinstance(getattr(prior, "__self__", None), cls):
            return prior.__self__           # installed by an earlier wrapper
        if prior is not None and not getattr(prior, "_wrapped_by_lr_sched",
                                             False):
            return None
        fused = cls(opt, prior)

        def step(owner, closure=None):   # owner: fused, or opt when wrapped
            return fused.step(closure)

        if prior is not None:       # the scheduler looks for its mark
            step._wrapped_by_lr_sched = True
        opt.step = types.MethodType(step, fused)
        return fused

    def step(self, closure=None):
        opt = self._opt()
        self.updated = 0
        groups = _fused_groups(opt) if closure is None else None
        if groups is None:
            if self._prior is not None:
                return self._prior(closure)
            return type(opt).step(opt, closure)
        if self._prior is not None:
            opt._opt_called = True      # what the scheduler's wrapper marks
        self.updated = _fused_step(opt, groups)
        return None
