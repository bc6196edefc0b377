"""Port vs JAX: decentralized vision training at world 4, the input feed,
and the ResNet-50 benchmark's step.

``DistributedNeighborAllreduceOptimizer`` around SGD (lr 0.1, momentum 0.9)
trains ``ResNet18(num_filters=8, num_classes=10)`` in f32 for three steps
on 2 images of 64x64 per rank: the port as four gloo processes, JAX with
``with_model_state=True`` on its 4-device CPU mesh, from the same flax init
and numpy batches. Per rank, the losses must agree to 1e-5 (measured
<= 7.2e-7), the parameters to 1e-4 of each tensor's largest value (measured
<= 1.3e-5) and the BatchNorm statistics, which each rank keeps to itself,
to 1e-5.

At 32x32 the last stage is 1x1, and its train-mode BatchNorms normalise 2
values per channel: x_hat is then +-|d|/sqrt(d^2 + eps) for the two
values' gap d, and in three SGD steps the two sides' f32 rounding grows
far past these limits on some ranks. At 64x64 each such norm sees 8
values and the two agree as above.
"""

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
from bluefog_tpu.models import ResNet18
from conftest import cpu_devices
from _torch_port_child import run_world

import bluefog_tpu_torch as bft
from bluefog_tpu_torch import bench
from bluefog_tpu_torch.utils import params_from_jax, prefetch_to_device

N = 4
B, IMAGE, STEPS = 2, 64, 3
CFG = dict(num_filters=8, num_classes=10)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if hasattr(v, "items") else
                   {key: np.asarray(v, np.float32)})
    return out


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp

    model = ResNet18(**CFG, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    images = rng.standard_normal((N, B, IMAGE, IMAGE, 3)).astype(np.float32)
    labels = rng.integers(0, CFG["num_classes"], (N, B)).astype(np.int32)
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(0), images[0],
                               train=False))
    return model, variables, images, labels


@pytest.fixture(scope="module")
def port_run(setup, tmp_path_factory):
    _, variables, images, labels = setup
    d = tmp_path_factory.mktemp("torch_port_vision")
    np.savez(d / "inputs.npz", images=images, labels=labels, steps=STEPS,
             **CFG, **{f"v:{k}": v for k, v in _flat(variables).items()})
    return run_world("vision", str(d), world=N)


@pytest.fixture(scope="module")
def jax_run(setup):
    import jax
    import optax

    model, variables, images, labels = setup

    def loss_fn(p, ms, batch):
        x, y = batch
        logits, upd = model.apply({"params": p, "batch_stats": ms}, x,
                                  train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, (upd["batch_stats"], {})

    bf.init(devices=cpu_devices(N))
    try:
        opt = bf.DistributedNeighborAllreduceOptimizer(
            optax.sgd(0.1, momentum=0.9), loss_fn, with_model_state=True)
        state = opt.init(variables["params"],
                         model_state=variables["batch_stats"])
        losses = []
        for _ in range(STEPS):
            state, metrics = opt.step(state, (images, labels))
            losses.append(np.asarray(metrics["loss"]))
        tree = jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.model_state})
        return tree, np.stack(losses, axis=1)
    finally:
        bf.shutdown()


def _rank(tree, r):
    return {k: _rank(v, r) if hasattr(v, "items") else v[r]
            for k, v in tree.items()}


@pytest.mark.parametrize("rank", range(N))
def test_port_vision_matches_jax(rank, port_run, jax_run):
    tree, jax_losses = jax_run
    port = port_run[rank]
    np.testing.assert_allclose(port["losses"], jax_losses[rank], rtol=0,
                               atol=1e-5)
    want = params_from_jax(_rank(tree, rank))
    assert set(want) == {k[len("sd:"):] for k in port if k.startswith("sd:")}
    for name, w in want.items():
        got, w = port[f"sd:{name}"], w.numpy()
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-5,
                                       err_msg=f"rank {rank} {name}")
        else:
            err = np.abs(got - w).max() / np.abs(w).max()
            assert err <= 1e-4, (rank, name, err)


def test_port_vision_ranks_differ(port_run):
    """The ranks' batches differ, so after the combine their parameters
    differ, and their BatchNorm statistics, never combined, differ too."""
    a, b = port_run[0], port_run[1]
    assert not np.allclose(a["sd:head.weight"], b["sd:head.weight"])
    assert not np.allclose(a["sd:bn_init.mean"], b["sd:bn_init.mean"])


def test_batch_norm_buffers_are_not_communicated(port_run, jax_run):
    """Each rank's running statistics are what its own three forward
    passes made of them: rank 0's differ from the average of the ranks'
    (what a combine of the buffers would have moved them towards), and
    they equal JAX's per-rank ``batch_stats``, which JAX never combines."""
    tree, _ = jax_run
    mean0 = port_run[0]["sd:bn_init.mean"]
    avg = np.mean([p["sd:bn_init.mean"] for p in port_run], axis=0)
    assert not np.allclose(mean0, avg, atol=1e-6)
    np.testing.assert_allclose(
        mean0, tree["batch_stats"]["bn_init"]["mean"][0], rtol=0, atol=1e-5)


# -- utils/data.py: prefetch_to_device (the cases of test_data_pipeline.py)

def test_prefetch_yields_all_batches_in_order():
    batches = [(np.full((8, 2), i, np.float32), np.full((8,), i, np.int32))
               for i in range(5)]
    out = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for i, (x, y) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), batches[i][0])
        np.testing.assert_array_equal(y.numpy(), batches[i][1])


def test_prefetch_keeps_transfers_in_flight():
    """With size=k the iterator stays k ahead of the consumer: after
    pulling batch 0, batches 0..k-1 have been submitted."""
    submitted = []

    def producer():
        for i in range(6):
            submitted.append(i)
            yield np.full((8, 1), i, np.float32)

    it = prefetch_to_device(producer(), size=3, device="cpu")
    first = next(it)
    assert float(first[0, 0]) == 0.0
    assert submitted == [0, 1, 2]
    rest = list(it)
    assert len(rest) == 5 and submitted == list(range(6))


def test_prefetch_size_validation():
    # raises at the call site, not deferred to the first next()
    with pytest.raises(ValueError):
        prefetch_to_device(iter([]), size=0, device="cpu")


def test_prefetch_short_iterator_drains():
    out = list(prefetch_to_device(iter([np.ones((8, 1), np.float32)]),
                                  size=4, device="cpu"))
    assert len(out) == 1


def test_prefetch_device_tensors_pass_through():
    x = torch.ones(3)
    batch = {"x": x, "y": [x, 7]}
    (out,) = list(prefetch_to_device(iter([batch]), size=1, device="cpu"))
    assert out["x"] is x and out["y"][0] is x and out["y"][1] == 7


# -- bluefog_tpu_torch/bench.py on the CPU

def test_bench_setup_and_one_step_on_cpu():
    """``bench.setup`` builds the benchmark's ResNet-50 step (1000
    classes, 224x224) at 2 images; one step gives a finite loss and moves
    the weights."""
    opt, batch, sync = bench.setup(batch_per_chip=2, device="cpu")
    try:
        assert bft.size() == 1
        images, labels = batch
        assert images.shape == (2, bench.IMAGE, bench.IMAGE, 3)
        assert not labels.any()
        head = opt.model.head.weight.detach().clone()
        loss = float(opt.step(batch)["loss"])
        sync()
        assert np.isfinite(loss)
        assert not torch.equal(head, opt.model.head.weight)
        n_params = sum(p.numel() for p in opt.model.parameters())
        assert n_params == 25_557_032
    finally:
        bft.shutdown()
    assert not torch.distributed.is_initialized()


def test_bench_host_pool_is_uint8_and_normalised_by_the_loss():
    pool = bench.host_batch_pool(2, pool=2, image=8)
    images, labels = next(pool)
    assert images.dtype == torch.uint8 and images.shape == (2, 8, 8, 3)
    assert labels.dtype == torch.int64
    model = bft.models.MLP(in_features=8 * 8 * 3, device="cpu")
    loss = bft.models.classification_loss(model, (images, labels % 10))
    assert torch.isfinite(loss)
