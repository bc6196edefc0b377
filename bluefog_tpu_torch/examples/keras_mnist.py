"""Decentralized training of per-rank Keras models (bluefog_tpu_torch.keras).

The port of ``examples/keras_mnist.py`` on the Keras torch backend: each
rank trains its own Keras replica on its disjoint synthetic shard, with the
wrapped optimizer averaging the gradients across ranks (the reference TF
``DistributedOptimizer`` semantics), and every replica ends bit-close to
every other. The gradients come from torch autograd through the Keras
model. Needs Keras 3 installed.

Run at world 4 on the CPU through the port's launcher:

    python -m bluefog_tpu_torch.launcher --simulate 4 -- \\
        python -m bluefog_tpu_torch.examples.keras_mnist
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

import bluefog_tpu_torch as bf

STEPS = 40


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu; under bfrun --simulate "
                        "the default is the CPU")
    args = p.parse_args(argv)
    bf.init(device=args.device)
    try:
        return _run()
    finally:
        bf.shutdown()


def _run() -> int:
    # Keras reads its backend and its device once, at import: the torch
    # backend, on the runtime's device
    os.environ.setdefault("KERAS_BACKEND", "torch")
    os.environ.setdefault("KERAS_TORCH_DEVICE",
                          str(bf.runtime.state._global_state().device))
    import keras

    import bluefog_tpu_torch.keras as bfk

    n, me = bf.size(), bf.rank()
    rng = np.random.RandomState(0)
    # synthetic 8x8 "digits": each rank sees its own shard
    xs = rng.randn(n, 256, 64).astype(np.float32)
    w_true = rng.randn(64, 10).astype(np.float32)
    ys = np.argmax(np.einsum("rbd,dk->rbk", xs, w_true), axis=-1)

    keras.utils.set_random_seed(me)  # deliberately divergent init
    model = keras.Sequential([keras.layers.Dense(32, activation="relu"),
                              keras.layers.Dense(10)])
    model.build((None, 64))
    bfk.broadcast_variables(model, root_rank=0)
    opt = bfk.DistributedOptimizer(
        lambda: keras.optimizers.Adam(1e-2), model,
        communication_type="allreduce")
    loss_fn = keras.losses.SparseCategoricalCrossentropy(from_logits=True)

    dev = model.trainable_variables[0].value.device
    x = torch.as_tensor(xs[me], device=dev)
    y = torch.as_tensor(ys[me], device=dev)
    for _ in range(STEPS):
        loss = loss_fn(y, model(x))
        grads = torch.autograd.grad(
            loss, [v.value for v in model.trainable_variables])
        opt.apply_stacked([list(grads)])

    # all replicas took identical mean-gradient steps from a common init:
    # they must agree, and fit their shards
    with torch.no_grad():
        acc = (model(x).argmax(-1) == y).float().mean().reshape(1)
        w = model.trainable_variables[0].value.detach()
        ws = bf.allgather(w[None])
        spread = float((ws - ws[0]).abs().max())
        mean_acc = float(bf.allreduce(acc))
    if me == 0:
        print(f"ranks: {n} (keras frontend), mean shard accuracy "
              f"{mean_acc:.3f}, replica spread {spread:.2e}", flush=True)
    assert spread < 1e-5, spread
    assert mean_acc > 0.55, mean_acc
    if me == 0:
        print("KERAS TRAIN OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
