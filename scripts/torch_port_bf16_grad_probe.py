#!/usr/bin/env python3
"""How far bf16 gradients of a random-init ResNet are from f32, in flax and
in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_port_bf16_grad_probe.py [--seed N]

For ResNet-18 (8 filters, 10 classes) at 2 images of 224x224 and ResNet-50
(8 filters) at 16 images of 32x32, from one flax init (BatchNorm scales and
biases redrawn as in ``tests/test_torch_port_vision.py``), it takes the
gradient of the mean cross-entropy in train mode four ways (flax f32 and
bf16, port f32 and bf16) and prints, per pair, the median and largest
per-tensor error (max|a - b| / max|b|) and the relative L2 error of all
gradients as one vector. The yardstick for the limits of the bf16 check in
``chip_smoke.py``: the bf16 error is the model's, not the port's.

By default XLA keeps the f32 value of a bf16 op inside a fusion, and
flax's bf16 gradients sit closer to its f32 ones than the port's, which
rounds after every op as eager PyTorch does. With
``XLA_FLAGS=--xla_allow_excess_precision=false`` XLA rounds after every op
too.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bluefog_tpu import models as jm  # noqa: E402
import bluefog_tpu_torch.models as tm  # noqa: E402
from bluefog_tpu_torch.utils import params_from_jax  # noqa: E402
from test_torch_port_vision import _init  # noqa: E402

CASES = {
    "ResNet-18 2x224x224": (jm.ResNet18, tm.ResNet18, (2, 224, 224, 3)),
    "ResNet-50 16x32x32": (jm.ResNet50, tm.ResNet50, (16, 32, 32, 3)),
}


def _compare(a, b) -> str:
    errs = sorted(float((a[k] - b[k]).abs().max() / b[k].abs().max())
                  for k in b)
    va = torch.cat([a[k].reshape(-1).double() for k in sorted(b)])
    vb = torch.cat([b[k].reshape(-1).double() for k in sorted(b)])
    return (f"median {errs[len(errs) // 2]:.4f} max {errs[-1]:.4f} "
            f"L2 {float((va - vb).norm() / vb.norm()):.4f}")


def main(seed: int) -> None:
    for label, (jcls, pcls, shape) in CASES.items():
        rng = np.random.default_rng(seed)
        x = rng.standard_normal(shape).astype(np.float32)
        y = rng.integers(0, 10, (shape[0],)).astype(np.int32)
        v = _init(jcls(num_filters=8, num_classes=10, dtype=jnp.float32), x,
                  rng)
        grads = {}
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            jmodel = jcls(num_filters=8, num_classes=10, dtype=dt)

            def loss(p, jmodel=jmodel):
                logits, _ = jmodel.apply(dict(v, params=p), x, train=True,
                                         mutable=["batch_stats"])
                return -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                            y[:, None], axis=1).mean()

            g = jax.tree_util.tree_map(
                np.asarray, jax.jit(jax.grad(loss))(v["params"]))
            grads["flax " + name] = params_from_jax(g)
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            model = pcls(num_filters=8, num_classes=10, dtype=dt,
                         device="cpu")
            model.load_state_dict(params_from_jax(v))
            tm.classification_loss(model, (torch.from_numpy(x),
                                           torch.from_numpy(y))).backward()
            grads["port " + name] = {k: p.grad.float()
                                     for k, p in model.named_parameters()}
        for a, b in (("flax bf16", "flax f32"), ("port bf16", "port f32"),
                     ("port f32", "flax f32"), ("port bf16", "flax bf16")):
            print(f"{label}: {a} vs {b}: {_compare(grads[a], grads[b])}",
                  flush=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0,
                   help="numpy seed of the inputs and the BatchNorm redraw")
    main(p.parse_args().seed)
