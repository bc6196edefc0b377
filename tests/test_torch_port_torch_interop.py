"""Port vs JAX: torchvision-format weights into the vision models.

The cases of ``tests/test_torch_interop.py``, with torchvision's names and
layouts built by hand from a numpy seed (torchvision is not installed):
the same numpy ``state_dict`` goes through JAX's ``resnet_from_torch``/
``vgg_from_torch`` into flax and through the port's into its own model.

  * ResNet-18 (8 filters, 10 classes, 32x32, every BatchNorm's statistics
    redrawn): the port's converted ``state_dict`` equals
    ``params_from_jax`` of JAX's converted variables tensor for tensor, and
    the eval logits agree to 1e-4 of the largest (``TOL_EVAL`` of
    ``tests/test_torch_port_vision.py`` for these models);
  * the ResNet-50 (bottleneck) mapping covers the whole model: it loads
    strictly and equals ``params_from_jax`` of JAX's conversion;
  * VGG11-BN at 224x224 (``classifier.0`` reads the 7x7 map in torch's CHW
    order, the port flattens HWC): equal to ``params_from_jax`` of JAX's,
    and the eval logits to 1e-4;
  * the plain VGG's structure, and the errors (unsupported depth, a deeper
    checkpoint, a shallower one, a VGG of another depth), with JAX's
    messages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bluefog_tpu import models as jm
from bluefog_tpu.utils import torch_interop as jax_interop
import bluefog_tpu_torch.models as tm
from bluefog_tpu_torch.utils import (params_from_jax, resnet_from_torch,
                                     vgg_from_torch)
from bluefog_tpu_torch.models.vgg import _CFGS

TOL_EVAL = 1e-4
_LAYOUTS = {18: ([2, 2, 2, 2], False), 50: ([3, 4, 6, 3], True)}


def _bn(sd, name, c, rng, small=False):
    lo, hi = (0.1, 0.3) if small else (0.5, 1.5)
    sd[f"{name}.weight"] = rng.uniform(lo, hi, c).astype(np.float32)
    sd[f"{name}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    sd[f"{name}.running_mean"] = (0.1 * rng.standard_normal(c)).astype(
        np.float32)
    sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sd[f"{name}.num_batches_tracked"] = np.array(7)


def _conv(sd, name, cout, cin, k, rng, bias=False):
    sd[f"{name}.weight"] = rng.standard_normal(
        (cout, cin, k, k), dtype=np.float32) * np.float32(
            (cin * k * k) ** -0.5)
    if bias:
        sd[f"{name}.bias"] = (0.1 * rng.standard_normal(cout)).astype(
            np.float32)


def _linear(sd, name, cout, cin, rng):
    sd[f"{name}.weight"] = rng.standard_normal(
        (cout, cin), dtype=np.float32) * np.float32(cin ** -0.5)
    sd[f"{name}.bias"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)


def torchvision_resnet(depth, filters, classes, seed):
    """A torchvision-format ResNet ``state_dict`` (numpy), name for name;
    each block's last BatchNorm scale small, as its zero init intends."""
    stages, bottleneck = _LAYOUTS[depth]
    rng = np.random.default_rng(seed)
    sd = {}
    _conv(sd, "conv1", filters, 3, 7, rng)
    _bn(sd, "bn1", filters, rng)
    cin = filters
    for s, count in enumerate(stages, start=1):
        w = filters * 2 ** (s - 1)
        for b in range(count):
            p = f"layer{s}.{b}"
            stride = 2 if s > 1 and b == 0 else 1
            if bottleneck:
                cout = 4 * w
                shapes = [(w, cin, 1), (w, w, 3), (cout, w, 1)]
            else:
                cout = w
                shapes = [(w, cin, 3), (w, w, 3)]
            for c, (co, ci, k) in enumerate(shapes, start=1):
                _conv(sd, f"{p}.conv{c}", co, ci, k, rng)
                _bn(sd, f"{p}.bn{c}", co, rng, small=c == len(shapes))
            if stride != 1 or cin != cout:
                _conv(sd, f"{p}.downsample.0", cout, cin, 1, rng)
                _bn(sd, f"{p}.downsample.1", cout, rng)
            cin = cout
    _linear(sd, "fc", classes, cin, rng)
    return sd


def torchvision_vgg(depth, batch_norm, classes, seed):
    """torchvision's ``VGG`` ``state_dict`` (``make_layers`` indices)."""
    rng = np.random.default_rng(seed)
    sd, idx, cin = {}, 0, 3
    for v in _CFGS[depth]:
        if v == "M":
            idx += 1
            continue
        _conv(sd, f"features.{idx}", v, cin, 3, rng, bias=True)
        idx += 1
        if batch_norm:
            _bn(sd, f"features.{idx}", v, rng)
            idx += 1
        idx += 1
        cin = v
    _linear(sd, "classifier.0", 4096, 512 * 7 * 7, rng)
    _linear(sd, "classifier.3", 4096, 4096, rng)
    _linear(sd, "classifier.6", classes, 4096, rng)
    return sd


def _same_as_jax(got, jax_variables):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_variables))
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def _nerr(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_resnet18_matches_jax_converter_and_flax():
    sd = torchvision_resnet(18, 8, 10, seed=0)
    x = np.random.default_rng(1).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    jvars = jax_interop.resnet_from_torch(sd, 18)
    want = jm.ResNet18(num_filters=8, num_classes=10,
                       dtype=jnp.float32).apply(jvars, x, train=False)
    got_sd = resnet_from_torch(sd, 18)
    _same_as_jax(got_sd, jvars)
    model = tm.ResNet18(num_filters=8, num_classes=10, dtype=torch.float32,
                        device="cpu")
    model.load_state_dict(got_sd, strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert _nerr(got, want) <= TOL_EVAL


def test_resnet50_mapping_covers_full_model():
    sd = torchvision_resnet(50, 8, 7, seed=2)
    got = resnet_from_torch(sd, 50)
    _same_as_jax(got, jax_interop.resnet_from_torch(sd, 50))
    model = tm.ResNet50(num_filters=8, num_classes=7, dtype=torch.float32,
                        device="cpu")
    missing, unexpected = model.load_state_dict(got, strict=True)
    assert not missing and not unexpected
    # values survive the renaming, untransposed
    assert torch.equal(got["BottleneckBlock_3.Conv_1.weight"],
                       torch.from_numpy(sd["layer2.0.conv2.weight"]))


def test_vgg11_bn_matches_jax_converter_and_flax():
    sd = torchvision_vgg(11, True, 7, seed=3)
    x = np.random.default_rng(4).standard_normal((1, 224, 224, 3)).astype(
        np.float32)
    jvars = jax_interop.vgg_from_torch(sd, 11)
    want = jm.VGG11(num_classes=7, dropout_rate=0.0,
                    dtype=jnp.float32).apply(jvars, x, train=False)
    got_sd = vgg_from_torch(sd, 11)
    _same_as_jax(got_sd, jvars)
    model = tm.VGG11(num_classes=7, dropout_rate=0.0, dtype=torch.float32,
                     device="cpu")
    model.load_state_dict(got_sd, strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert _nerr(got, want) <= TOL_EVAL


def test_vgg_plain_structure_and_errors():
    sd = torchvision_vgg(11, False, 7, seed=5)
    got = vgg_from_torch(sd, 11)
    assert not any(k.startswith("bn_") for k in got)
    assert len([k for k in got if k.startswith("conv_")
                and k.endswith(".weight")]) == 8
    assert tuple(got["fc_0.weight"].shape) == (4096, 25088)
    model = tm.VGG11(num_classes=7, batch_norm=False, device="cpu")
    model.load_state_dict(got, strict=True)
    for depth in (16, 13):
        with pytest.raises(ValueError) as want:
            jax_interop.vgg_from_torch(sd, depth)
        with pytest.raises(ValueError) as exc:
            vgg_from_torch(sd, depth)
        assert ("matching depth" in str(exc.value)) == \
            ("matching depth" in str(want.value))
        assert ("unsupported depth" in str(exc.value)) == \
            ("unsupported depth" in str(want.value))


def _deeper(sd):
    """An extra block grafted on, as if the checkpoint were deeper."""
    sd = dict(sd)
    for k in list(sd):
        if k.startswith("layer4.1."):
            sd[k.replace("layer4.1.", "layer4.2.")] = sd[k]
    return sd


@pytest.mark.parametrize("case", ["unsupported", "deeper", "shallower"])
def test_resnet_errors_read_as_jax(case):
    sd = torchvision_resnet(18, 8, 10, seed=6)
    sd, depth = {"unsupported": ({}, 77), "deeper": (_deeper(sd), 18),
                 "shallower": (sd, 34)}[case]
    with pytest.raises(ValueError) as want:
        jax_interop.resnet_from_torch(sd, depth)
    with pytest.raises(ValueError) as got:
        resnet_from_torch(sd, depth)
    assert str(got.value) == str(want.value)
