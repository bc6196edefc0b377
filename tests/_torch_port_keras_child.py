"""Both sides of the Keras frontend comparison (``test_torch_port_keras.py``).

Keras fixes its backend when it is imported, so each side is a process of
its own:

    python _torch_port_keras_child.py jax <dir>
        KERAS_BACKEND=jax, one process over 4 forced CPU devices, JAX's
        ``bluefog_tpu.keras`` with every rank's replica; writes
        ``<dir>/jax.npz`` and ``<dir>/jax.json``;
    python _torch_port_keras_child.py port <rank> <world> <dir>
        KERAS_BACKEND=torch with ``jax``, ``jaxlib``, ``flax`` and ``optax``
        blocked before anything is imported; one rank of a gloo world over
        ``<dir>/store`` running ``bluefog_tpu_torch.keras`` on its replica;
        writes ``<dir>/out_<rank>.npz`` and ``<dir>/out_<rank>.json``.

Both read ``<dir>/inputs.npz`` (per-rank weights ``k``, ``b`` and per-step
gradients ``gk``, ``gb``, made by the parent with numpy from a seed), run
the same scenarios and store each rank's weights after them, and the
messages of the frontend's refusals.
"""

from __future__ import annotations

import json
import os
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax")

if __name__ == "__main__" and sys.argv[1] == "port":
    for _m in BLOCKED:
        sys.modules[_m] = None
    os.environ["KERAS_BACKEND"] = "torch"
    os.environ["KERAS_TORCH_DEVICE"] = "cpu"
elif __name__ == "__main__":
    os.environ["KERAS_BACKEND"] = "jax"
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import numpy as np  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

NEIGHBOR_STEPS = 3
LOCAL_STEPS = 3


def _model(keras):
    m = keras.Sequential([keras.layers.Dense(2, use_bias=True)])
    m.build((None, 4))
    return m


def _message(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return "no error"


def _scenarios(keras, bfk, ranks, inp):
    """Run every scenario on ``ranks`` (the rank indices this process
    holds, one model each); returns ``{name: [per-held-rank weights]}``
    and the refusals' messages."""
    out = {}

    def fresh(source_rank=None):
        ms = []
        for r in ranks:
            s = r if source_rank is None else source_rank
            m = _model(keras)
            m.set_weights([inp["k"][s], inp["b"][s]])
            ms.append(m)
        return ms

    def grads(step):
        return [[inp["gk"][step, r], inp["gb"][step, r]] for r in ranks]

    def keep(name, ms):
        for m in ms:
            w = [np.asarray(v) for v in m.trainable_variables]
            out.setdefault(f"{name}_k", []).append(w[0])
            out.setdefault(f"{name}_b", []).append(w[1])

    ms = fresh()
    bfk.broadcast_variables(ms, root_rank=3)
    keep("bcast", ms)

    ms = fresh(source_rank=0)          # an identical start
    opt = bfk.DistributedOptimizer(lambda: keras.optimizers.SGD(0.5), ms,
                                   communication_type="allreduce")
    opt.apply_stacked(grads(0))
    keep("allreduce", ms)
    lr = float(np.asarray(opt.learning_rate))

    ms = fresh()
    opt = bfk.DistributedOptimizer(lambda: keras.optimizers.SGD(0.1), ms,
                                   communication_type="neighbor.allreduce")
    for step in range(NEIGHBOR_STEPS):
        opt.apply_stacked(grads(step))
        keep(f"neighbor{step + 1}", ms)

    ms = fresh()
    opt = bfk.DistributedOptimizer(lambda: keras.optimizers.SGD(0.5), ms,
                                   communication_type="allreduce",
                                   num_steps_per_communication=2)
    for step in range(LOCAL_STEPS):
        opt.apply_stacked(grads(step))
        keep(f"every2_{step + 1}", ms)

    # refusals: a second model in the list stands for "several replicas"
    one = fresh()
    two = one + [_model(keras)]
    opt = bfk.DistributedOptimizer(lambda: keras.optimizers.SGD(0.1), one)
    msgs = {
        "communication_type": _message(lambda: bfk.DistributedOptimizer(
            lambda: keras.optimizers.SGD(0.1), one,
            communication_type="bogus")),
        "factory": _message(lambda: bfk.DistributedOptimizer(
            keras.optimizers.SGD(0.1), two)),
        "optimizer_list": _message(lambda: bfk.DistributedOptimizer(
            [keras.optimizers.SGD(0.1)], two)),
        "gradient_lists": _message(lambda: opt.apply_stacked(
            grads(0) + grads(0))),
        "apply_gradients": _message(
            lambda: bfk.DistributedOptimizer(
                lambda: keras.optimizers.SGD(0.1), two).apply_gradients(
                    zip(grads(0)[0], two[0].trainable_variables))),
        "replicas": _message(lambda: bfk.broadcast_variables(
            one[:1] * (len(one) + 1))),
        "learning_rate": repr(lr),
    }
    return out, msgs


def _jax(d: str) -> None:
    import keras

    import bluefog_tpu as bf
    import bluefog_tpu.keras as bfk
    import jax

    bf.init(devices=jax.devices("cpu")[:4])
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    out, msgs = _scenarios(keras, bfk, list(range(4)), inp)
    bf.shutdown()
    np.savez(os.path.join(d, "jax.npz"),
             **{k: np.stack(v) for k, v in out.items()})
    with open(os.path.join(d, "jax.json"), "w") as f:
        json.dump(msgs, f)


def _port(rank: int, world: int, d: str) -> None:
    import keras

    import bluefog_tpu_torch as bf
    import bluefog_tpu_torch.keras as bfk

    bf.init(device="cpu", init_method=f"file://{os.path.join(d, 'store')}",
            rank=rank, world_size=world)
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    out, msgs = _scenarios(keras, bfk, [rank], inp)
    bf.shutdown()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED + ("bluefog_tpu",)
                    and sys.modules[m] is not None)
    msgs["loaded"] = loaded
    np.savez(os.path.join(d, f"out_{rank}.npz"),
             **{k: v[0] for k, v in out.items()})
    with open(os.path.join(d, f"out_{rank}.json"), "w") as f:
        json.dump(msgs, f)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax(sys.argv[2])
    else:
        _port(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
