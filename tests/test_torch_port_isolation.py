"""The port stands alone, and runs on the CPU only when asked to.

A fresh interpreter imports every module of ``bluefog_tpu_torch`` and
``chip_smoke.py`` and must find neither JAX, flax, optax, ``ml_dtypes`` nor
any module of the JAX package loaded (the card's machine has no
``ml_dtypes``: the port's bf16 and fp8 host rows go through torch). On this GPU-less machine the entry points raise
unless ``device="cpu"`` is passed. The port's public names are names of
the JAX package too: it adds no feature the JAX package lacks.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import bluefog_tpu
import bluefog_tpu.parallel
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import bench, lm_bench
from bluefog_tpu_torch.examples import (average_consensus, benchmark,
                                        long_context_lm, mnist, moe,
                                        optimization, resnet)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import bluefog_tpu_torch, chip_smoke
for m in pkgutil.walk_packages(bluefog_tpu_torch.__path__, "bluefog_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "ml_dtypes", "bluefog_tpu"))
assert not bad, bad
print("clean", len([m for m in sys.modules if m.startswith("bluefog_tpu_torch")]))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=_REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("clean")


_ENTRIES = {
    "init": lambda: bft.init(),
    "init(local_size=1)": lambda: bft.init(local_size=1),
    "TransformerLM": lambda: bft.models.TransformerLM(vocab_size=16),
    "MoETransformerLM": lambda: bft.models.MoETransformerLM(16, 4),
    "SwitchFFN": lambda: bft.parallel.SwitchFFN(8, 4, 16),
    "lm_bench.run": lambda: lm_bench.run(64, 32, 1, 2, 1, 16, 1, 0, False),
    "ResNet50": lambda: bft.models.ResNet50(),
    "VGG16": lambda: bft.models.VGG16(),
    "bench.setup": lambda: bench.setup(),
    "prefetch_to_device": lambda: bft.utils.prefetch_to_device(iter([])),
    "long_context_lm.main": lambda: long_context_lm.main(["--steps", "1"]),
    "long_context_lm.main --attention ulysses": lambda: long_context_lm.main(
        ["--steps", "1", "--attention", "ulysses"]),
    "long_context_lm.main --attention flash": lambda: long_context_lm.main(
        ["--steps", "1", "--attention", "flash"]),
    "moe.main": lambda: moe.main(["--experts", "1", "--steps", "1"]),
    "average_consensus.main": lambda: average_consensus.main([]),
    "mnist.main": lambda: mnist.main(["--epochs", "1"]),
    "optimization.main": lambda: optimization.main(["--max-iter", "1"]),
    "benchmark.main": lambda: benchmark.main(["--model", "mlp"]),
    "resnet.train": lambda: resnet.train(resnet.parse_args(["--epochs", "1"])),
}


@pytest.mark.parametrize("entry", list(_ENTRIES))
def test_port_entry_points_refuse_cpu_fallback(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _ENTRIES[entry]()
    assert not torch.distributed.is_initialized()


# the names the hierarchical/ZeRO-1 slice ports (ROADMAP Queue 1, item 1)
_SLICE_NAMES = [
    "num_machines", "machine_size", "is_homogeneous",
    "set_skip_negotiate_stage", "get_skip_negotiate_stage",
    "mpi_threads_supported", "nccl_built", "poll", "synchronize", "wait",
    "allreduce_", "allreduce_nonblocking", "allreduce_nonblocking_",
    "broadcast_", "broadcast_nonblocking", "broadcast_nonblocking_",
    "allgather", "allgather_nonblocking", "allgather_v",
    "allgather_v_nonblocking", "pair_gossip", "pair_gossip_nonblocking",
    "neighbor_allreduce_nonblocking", "hierarchical_neighbor_allreduce",
    "hierarchical_neighbor_allreduce_nonblocking", "neighbor_allgather",
    "neighbor_allgather_nonblocking",
    "DistributedHierarchicalNeighborAllreduceOptimizer",
    "DistributedShardedAllreduceOptimizer", "broadcast_optimizer_state",
    # the context-parallel and checkpoint slice (ROADMAP Queue 1, items 2-3)
    "checkpoint",
    # the wire (Queue 1, item 5(b1)) and the torchvision converters
    "PeerLostError", "QuorumLostError", "StaleIncarnationError",
    "cluster_health", "resnet_from_torch", "vgg_from_torch",
    # failure detection (Queue 1, item 5(b2))
    "dead_controllers", "suspect_controllers", "dead_ranks",
    "membership_epoch", "shutdown_requested",
    # the window layer (Queue 1, item 6(b))
    "win_accumulate", "win_accumulate_nonblocking", "win_associated_p",
    "win_associated_p_all", "win_create", "win_fence", "win_free", "win_get",
    "win_get_nonblocking", "win_lock", "win_mutex", "win_poll", "win_put",
    "win_put_nonblocking", "win_update", "win_update_then_collect",
    "win_wait", "get_win_version", "turn_on_win_ops_with_associated_p",
    "turn_off_win_ops_with_associated_p",
    "unified_mpi_window_model_supported",
]
_PARALLEL_SLICE_NAMES = ["ring_attention", "ring_attention_shard",
                         "ulysses_attention", "ulysses_attention_shard",
                         "cp_apply", "cp_loss_fn",
                         # expert parallelism (Queue 1, item 7)
                         "switch_dispatch", "ep_apply", "ep_place_params",
                         "moe_param_specs", "ep_lm_init", "ep_lm_apply",
                         "ep_lm_loss_fn",
                         # tensor and pipeline parallelism (Queue 1, item 7)
                         "LM_TP_RULES", "tp_shard_params", "tp_apply",
                         "tp_loss_fn", "pp_stack_params", "pp_place_params",
                         "pp_forward_fn", "pp_loss_fn", "pp_train_init",
                         "pp_train_step_fn", "pp_apply"]
_CHECKPOINT_NAMES = ["save", "save_async", "wait_pending", "restore",
                     "read_meta", "latest_path"]


def test_port_names_are_jax_names():
    """Every public name of a freshly imported ``bluefog_tpu_torch`` but its
    ``models``/``parallel``/``utils`` modules is a name of ``bluefog_tpu``,
    and each name this slice ports is present."""
    probe = ("import json, bluefog_tpu_torch as b; print(json.dumps(sorted("
             "n for n in vars(b) if not n.startswith('_'))))")
    res = subprocess.run([sys.executable, "-c", probe], cwd=_REPO,
                         env=dict(os.environ, PYTHONPATH=_REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(json.loads(res.stdout)) - {"models", "parallel", "utils"}
    assert sorted(names - set(dir(bluefog_tpu))) == []
    assert sorted(set(_SLICE_NAMES) - names) == []


def test_port_parallel_and_checkpoint_names_are_jax_names():
    """The context-parallel names of ``bluefog_tpu_torch.parallel`` and the
    checkpoint functions are present under the JAX package's names."""
    from bluefog_tpu import checkpoint as jax_ck

    for name in _PARALLEL_SLICE_NAMES:
        assert name in bft.parallel.__all__ and \
            name in bluefog_tpu.parallel.__all__, name
    for name in _CHECKPOINT_NAMES:
        assert callable(getattr(bft.checkpoint, name)), name
        assert callable(getattr(jax_ck, name)), name


# ``parallel`` and ``utils`` against the JAX package's: the port's own
# names (the flash backward and its launch counters, the JAX-weights loader),
# and the names absent on purpose (``ep_mesh``, ``tp_mesh``, ``pp_mesh`` and
# ``sequence_sharding`` build or place on a JAX device mesh, which the port
# has not); none is left to port
_PORT_ONLY = {"parallel": {"flash_block_bwd", "launch_counts",
                           "reset_launch_counts"},
              "utils": {"params_from_jax"}}
_ABSENT_ON_PURPOSE = {"parallel": {"ep_mesh", "tp_mesh", "pp_mesh",
                                   "sequence_sharding"},
                      "utils": set(),
                      # the package's top level: JAX's train state and
                      # device-mesh placement have no counterpart in one
                      # process per rank
                      "top": {"TrainState", "replicate", "unreplicate",
                              "mesh", "machine_mesh", "rank_sharding",
                              "shard_rank_stacked"}}
_NOT_YET = {"parallel": set(), "utils": set(),
            # ROADMAP Queue 1: 6(c) the window optimizers, 8 serving
            "top": {"DistributedWinPutOptimizer",
                    "DistributedPullGetOptimizer",
                    "DistributedPushSumOptimizer",
                    "ServeClient", "serve_client", "RequestShed"}}


def _init_names(path: str) -> set:
    """The public names an ``__init__.py`` binds at its top level (its
    imports, definitions and assignments), read from its source."""
    import ast

    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_port_top_level_names_against_jax():
    """The JAX package's top-level names that the port lacks are exactly
    those absent on purpose and those not yet ported (ROADMAP Queue 1);
    the port binds none the JAX package lacks."""
    jax_names = _init_names(os.path.join(_REPO, "bluefog_tpu",
                                         "__init__.py"))
    port = _init_names(os.path.join(_REPO, "bluefog_tpu_torch",
                                    "__init__.py"))
    assert port - jax_names == set()
    assert jax_names - port == _ABSENT_ON_PURPOSE["top"] | _NOT_YET["top"]
    assert len(_ABSENT_ON_PURPOSE["top"]) == 7
    assert len(_NOT_YET["top"]) == 6
    for name in ("resnet_from_torch", "vgg_from_torch"):
        assert getattr(bft, name) is getattr(bft.utils, name)


@pytest.mark.parametrize("module", ["parallel", "utils"])
def test_port_parallel_and_utils_names_are_jax_names(module):
    import bluefog_tpu.utils

    port = set(getattr(bft, module).__all__)
    jax_names = set(getattr(bluefog_tpu, module).__all__)
    assert port - jax_names == _PORT_ONLY[module]
    assert jax_names - port == _ABSENT_ON_PURPOSE[module] | _NOT_YET[module]


# the context-parallel and checkpoint entry points take the caller's
# tensors, modules and optimizer: they have no device of their own, and
# before ``init`` (whose default is the card) they refuse to run at all
_NEEDS_INIT = {
    "ring_attention": lambda q: bft.parallel.ring_attention(q, q, q),
    "ring_attention_shard": lambda q: bft.parallel.ring_attention_shard(
        q, q, q, use_flash=True),
    "ulysses_attention": lambda q: bft.parallel.ulysses_attention(q, q, q),
    "ulysses_attention_shard": lambda q: bft.parallel.ulysses_attention_shard(
        q, q, q),
    "cp_apply": lambda q: bft.parallel.cp_apply(
        bft.models.TransformerLM(vocab_size=16, device="cpu"),
        torch.zeros((1, 8), dtype=torch.long)),
    "cp_loss_fn": lambda q: bft.parallel.cp_loss_fn(
        bft.models.TransformerLM(vocab_size=16, device="cpu")),
    "checkpoint.restore": lambda q: bft.checkpoint.restore(
        "no_such_checkpoint", None),
    "SwitchFFN(expert_axis)": lambda q: bft.parallel.SwitchFFN(
        8, 1, 16, expert_axis="expert", device="cpu"),
    "ep_apply": lambda q: bft.parallel.ep_apply(
        bft.parallel.SwitchFFN(8, 1, 16, device="cpu").state_dict(),
        q[..., 0, :]),
    "MoETransformerLM(expert_axis)": lambda q: bft.models.MoETransformerLM(
        16, 1, expert_axis="expert", device="cpu"),
    "tp_shard_params": lambda q: bft.parallel.tp_shard_params(
        bft.models.TransformerLM(vocab_size=16, device="cpu")),
    "tp_apply": lambda q: bft.parallel.tp_apply(
        bft.models.TransformerLM(vocab_size=16, device="cpu"),
        torch.zeros((1, 8), dtype=torch.long)),
    "tp_loss_fn": lambda q: bft.parallel.tp_loss_fn(
        bft.models.TransformerLM(vocab_size=16, device="cpu")),
    "pp_place_params": lambda q: bft.parallel.pp_place_params({"w": q}),
    "pp_apply": lambda q: bft.parallel.pp_apply(
        bft.models.TransformerLM(vocab_size=16, device="cpu"),
        bft.models.TransformerLM(vocab_size=16, device="cpu").state_dict(),
        torch.zeros((2, 8), dtype=torch.long)),
    "pp_loss_fn": lambda q: bft.parallel.pp_loss_fn(
        bft.models.TransformerLM(vocab_size=16, device="cpu")),
}


@pytest.mark.parametrize("entry", list(_NEEDS_INIT))
def test_port_cp_and_checkpoint_need_init(entry):
    with pytest.raises(RuntimeError, match="bf.init"):
        _NEEDS_INIT[entry](torch.zeros((1, 8, 4, 8)))
    assert not torch.distributed.is_initialized()
