"""Port vs JAX: every vision model on the same inputs and weights, in f32.

Each case builds the flax model and the port's, carries the flax variables
across with ``params_from_jax`` (the BatchNorm scales, biases and running
statistics first redrawn from a numpy seed, so no block starts as the
identity its zero-initialised last scale would make it), and compares on
one numpy batch (16 images for the ResNets, whose last stage is 1x1 at
32x32):

  * eval logits (running statistics) to 1e-4 of the largest logit;
  * train-mode logits to 3e-5 of the largest (measured <= 9.7e-6, ResNet-50:
    train-mode BatchNorm carries f32 rounding down the depth), and the
    updated ``batch_stats`` to 1e-5 (flax reduces E[x^2] - E[x]^2, the
    port's fused kernel the centred variance: both f32);
  * the gradient of the mean cross-entropy against ``jax.grad``, each to
    1e-4 of its largest entry (measured <= 2.9e-5). The VGG conv biases
    feed a train-mode BatchNorm, which cancels them: their gradients are
    zero by the math, rounding noise in both, and are held below 1e-5 of
    the model's largest gradient on both sides instead.

ResNet18 and ResNet50 (8 filters, 10 classes, 32x32), the space-to-depth
stem, VGG11 without dropout at 64x64 (a 2x2 final map, so the NHWC flatten
order matters), MLP and LeNet5 at 28x28. Then one bf16 forward, and the
batch-norm fold against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu import models as jm
from bluefog_tpu.models.fold import fold_batchnorm as jax_fold_batchnorm

import bluefog_tpu_torch.models as tm
from bluefog_tpu_torch.utils import params_from_jax

TOL_EVAL = 1e-4
TOL_TRAIN = 3e-5
TOL_STATS = 1e-5
TOL_GRAD = 1e-4
# bf16 end to end (convs, norms' outputs, residual adds): a few bf16 ulps
# (2^-8 relative) of the largest logit, for backends that round at other
# points. On the CPU both sides round at the same points: measured 0.
TOL_BF16 = 2e-2


def _resnet(jcls, pcls, **fixed):
    return (lambda dt, **kw: jcls(num_filters=8, num_classes=10, dtype=dt,
                                  **fixed, **kw),
            lambda dt, **kw: pcls(num_filters=8, num_classes=10, dtype=dt,
                                  device="cpu", **fixed, **kw),
            (16, 32, 32, 3))


# name -> (flax builder, port builder, input shape); builders take the
# compute dtype and extra model arguments
CASES = {
    "resnet18": _resnet(jm.ResNet18, tm.ResNet18),
    "resnet50": _resnet(jm.ResNet50, tm.ResNet50),
    "resnet18_s2d": _resnet(jm.ResNet18, tm.ResNet18, stem="space_to_depth"),
    "vgg11": (lambda dt: jm.VGG11(num_classes=10, dropout_rate=0.0, dtype=dt),
              lambda dt: tm.VGG11(num_classes=10, dropout_rate=0.0, dtype=dt,
                                  image_size=64, device="cpu"),
              (2, 64, 64, 3)),
    "mlp": (lambda dt: jm.MLP(dtype=dt),
            lambda dt: tm.MLP(dtype=dt, device="cpu"), (4, 28, 28)),
    "lenet5": (lambda dt: jm.LeNet5(dtype=dt),
               lambda dt: tm.LeNet5(dtype=dt, device="cpu"), (4, 28, 28)),
}
RESNETS = ["resnet18", "resnet50", "resnet18_s2d"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _plain(tree):
    """flax variables -> nested dicts of writable numpy arrays."""
    return {k: _plain(v) if hasattr(v, "items") else np.array(v)
            for k, v in tree.items()}


def _init(jmodel, x, rng):
    """flax init, then every BatchNorm redrawn: scale ~ U(0.5, 1.5) (U(0.1,
    0.3) where flax starts it at zero), bias ~ N(0, 0.1), mean ~ N(0, 0.1),
    var ~ U(0.5, 1.5), so every branch is live and the eval statistics are
    not trivial. The residual branches stay small, as the zero init
    intends: at full scale a random ResNet-50 in train mode amplifies f32
    rounding so far that the port's f32 gradients are further than 1e-4
    from its own f64 ones, and no f32 comparison could hold 1e-4."""
    v = _plain(jmodel.init(jax.random.PRNGKey(0), x, train=False))

    def walk(p, s):
        for k, sub in p.items():
            if "scale" in sub and "kernel" not in sub:
                n = sub["scale"].shape
                lo, hi = (0.5, 1.5) if sub["scale"].any() else (0.1, 0.3)
                sub["scale"] = rng.uniform(lo, hi, n).astype(np.float32)
                sub["bias"] = (0.1 * rng.standard_normal(n)).astype(
                    np.float32)
                s[k]["mean"] = (0.1 * rng.standard_normal(n)).astype(
                    np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub, s.get(k, {}))
    walk(v["params"], v.get("batch_stats", {}))
    return v


def _nerr(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port(case, variables, dtype=torch.float32):
    model = CASES[case][1](dtype)
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name = request.param
    rng = np.random.default_rng(sorted(CASES).index(name))
    jmodel = CASES[name][0](jnp.float32)
    x = rng.standard_normal(CASES[name][2]).astype(np.float32)
    y = rng.integers(0, 10, (x.shape[0],)).astype(np.int32)
    variables = _init(jmodel, x, rng)
    has_bn = "batch_stats" in variables

    eval_logits = jmodel.apply(variables, x, train=False)
    if has_bn:
        train_logits, upd = jmodel.apply(variables, x, train=True,
                                         mutable=["batch_stats"])
        stats = _np(upd["batch_stats"])
    else:
        train_logits, stats = eval_logits, None

    def loss(p):
        v = dict(variables, params=p)
        if has_bn:
            logits, _ = jmodel.apply(v, x, train=True,
                                     mutable=["batch_stats"])
        else:
            logits = jmodel.apply(v, x, train=True)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                    y[:, None], axis=1).mean()

    grads = _np(jax.jit(jax.grad(loss))(variables["params"]))
    return dict(name=name, x=x, y=y, variables=variables,
                eval=np.asarray(eval_logits), train=np.asarray(train_logits),
                stats=stats, grads=grads)


def test_eval_logits(case):
    model = _port(case["name"], case["variables"]).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(case["x"]))
    assert got.dtype == torch.float32
    assert _nerr(got, case["eval"]) <= TOL_EVAL


def test_train_logits_and_batch_stats(case):
    model = _port(case["name"], case["variables"]).train()
    with torch.no_grad():
        got = model(torch.from_numpy(case["x"]))
    assert _nerr(got, case["train"]) <= TOL_TRAIN
    if case["stats"] is None:
        assert not list(model.buffers())
        return
    want = params_from_jax({"params": {}, "batch_stats": case["stats"]})
    bufs = dict(model.named_buffers())
    assert set(want) == set(bufs)
    for name, w in want.items():
        np.testing.assert_allclose(bufs[name].numpy(), w.numpy(), rtol=0,
                                   atol=TOL_STATS, err_msg=name)


def test_gradients(case):
    model = _port(case["name"], case["variables"]).train()
    loss = tm.classification_loss(model, (torch.from_numpy(case["x"]),
                                          torch.from_numpy(case["y"])))
    loss.backward()
    want = params_from_jax(case["grads"])
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(want) == set(got)
    zero = 1e-5 * max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        if float(w.abs().max()) <= zero:         # zero by the math
            assert float(got[name].abs().max()) <= zero, name
            continue
        assert _nerr(got[name], w) <= TOL_GRAD, name


def test_bf16_forward():
    """ResNet18 (8 filters) in bf16 compute, eval and train mode."""
    rng = np.random.default_rng(11)
    jmodel = CASES["resnet18"][0](jnp.bfloat16)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    variables = _init(jmodel, x, rng)
    want_eval = jmodel.apply(variables, x, train=False)
    want_train, _ = jmodel.apply(variables, x, train=True,
                                 mutable=["batch_stats"])
    model = _port("resnet18", variables, torch.bfloat16)
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x))
        got_train = model.train()(torch.from_numpy(x))
    assert got_eval.dtype == torch.float32
    assert _nerr(got_eval, want_eval) <= TOL_BF16
    assert _nerr(got_train, want_train) <= TOL_BF16


@pytest.mark.parametrize("name", RESNETS)
def test_fold_batchnorm_matches_jax(name):
    """The port's fold of the state dict equals JAX's fold of the tree, and
    the folded model's eval logits equal the unfolded model's and those of
    JAX's ``fold_bn=True`` model."""
    rng = np.random.default_rng(5)
    jbuild, pbuild, shape = CASES[name]
    x = rng.standard_normal(shape).astype(np.float32)
    v = _init(jbuild(jnp.float32), x, rng)
    jfolded = jax_fold_batchnorm(v["params"], v["batch_stats"])
    want = params_from_jax(_np(jfolded))
    got = tm.fold_batchnorm(params_from_jax(v))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)

    model = _port(name, v).eval()
    folded = pbuild(torch.float32, fold_bn=True).eval()
    folded.load_state_dict(tm.fold_batchnorm(model.state_dict()),
                           strict=True)
    with torch.no_grad():
        unfolded, out = model(torch.from_numpy(x)), folded(torch.from_numpy(x))
    jout = jbuild(jnp.float32, fold_bn=True).apply({"params": jfolded}, x,
                                                    train=False)
    assert _nerr(out, unfolded) <= TOL_EVAL
    assert _nerr(out, jout) <= TOL_EVAL


def test_fold_batchnorm_refuses_unpaired_norm():
    sd = params_from_jax({"params": {"bn_3": {"scale": np.ones(2),
                                              "bias": np.zeros(2)}},
                          "batch_stats": {"bn_3": {"mean": np.zeros(2),
                                                   "var": np.ones(2)}}})
    with pytest.raises(ValueError, match="pairing rule"):
        tm.fold_batchnorm(sd)
    del sd["bn_3.mean"]
    with pytest.raises(ValueError, match="mean/var"):
        tm.fold_batchnorm(sd)


def test_fold_bn_refuses_train_mode():
    model = CASES["resnet18"][1](torch.float32, fold_bn=True)
    with pytest.raises(ValueError, match="inference-only"):
        model(torch.zeros(1, 32, 32, 3))
    assert model.eval()(torch.zeros(1, 32, 32, 3)).shape == (1, 10)


def test_space_to_depth_rejects_odd_input():
    model = CASES["resnet18_s2d"][1](torch.float32)
    with pytest.raises(RuntimeError):
        model(torch.zeros(1, 33, 33, 3))
