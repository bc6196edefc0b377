"""The port stands alone, and runs on the CPU only when asked to.

A fresh interpreter imports every module of ``bluefog_tpu_torch`` and
``chip_smoke.py`` and must find neither JAX, flax, optax, ``ml_dtypes`` nor
any module of the JAX package loaded (the card's machine has no
``ml_dtypes``: the port's bf16 and fp8 host rows go through torch). On this GPU-less machine the entry points raise
unless ``device="cpu"`` is passed. The port's public names are names of
the JAX package too: it adds no feature the JAX package lacks.
"""

import importlib.util
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
from bluefog_tpu_torch import launcher, scaling
from bluefog_tpu_torch.examples import (average_consensus, benchmark,
                                        keras_mnist, long_context_lm, mnist,
                                        moe, optimization, resnet, serving)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The Keras frontend is left out of the walk: keras itself imports JAX
# where JAX is installed. Its own checks are the static scan and the child
# with JAX blocked below.
_PROBE = """
import importlib, pkgutil, sys
import bluefog_tpu_torch, chip_smoke
sys.modules["bluefog_tpu_torch.keras"] = None
for m in pkgutil.walk_packages(bluefog_tpu_torch.__path__, "bluefog_tpu_torch."):
    if m.name != "bluefog_tpu_torch.keras":
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


# The launcher's launch paths run (exec with a checked --chaos spec and the
# torchrun environment, --simulate, the fan-out with its shard servers and
# --elastic) and chip_smoke's launch helper imports what it runs; then no
# module of JAX or of the JAX package is loaded. The programs launched are
# a bare interpreter, so only the launcher's own imports count.
_LAUNCH_PROBE = """
import os, sys
import bluefog_tpu_torch.torch_frontend
import bluefog_tpu_torch.examples.torch_average_consensus
from bluefog_tpu_torch import launcher
os.execvpe = lambda *a: None
assert launcher.main(["--chaos", "drop_after=3", "-np", "2", "--coordinator",
                      "127.0.0.1:1", "--process-id", "1", "--", "prog"]) is None
noop = [sys.executable, "-c", "pass"]
assert launcher.main(["--simulate", "2", "--"] + noop) == 0
assert launcher.main(["-H", "localhost:2", "--cp-shards", "2", "--elastic=1",
                      "--"] + noop) == 0
import chip_smoke
chip_smoke._launch_helper_imports()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "ml_dtypes", "bluefog_tpu"))
assert not bad, bad
print("clean")
"""


_JAX_ROOTS = ("jax", "jaxlib", "flax", "optax", "bluefog_tpu")


def _imported_roots(path: str) -> set:
    """The top-level names of the modules ``path`` imports (absolute
    imports; a relative import stays inside the port)."""
    import ast

    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("rel", [
    "bluefog_tpu_torch/scaling.py", "bluefog_tpu_torch/keras/__init__.py",
    "bluefog_tpu_torch/examples/keras_mnist.py"])
def test_last_slice_modules_import_no_jax(rel):
    """The scaling module, the Keras frontend and its example import
    neither JAX, flax, optax nor the JAX package, and the package's
    ``__init__`` leaves the Keras frontend (and keras) alone."""
    assert _imported_roots(os.path.join(_REPO, rel)) & set(_JAX_ROOTS) == \
        set()
    init = os.path.join(_REPO, "bluefog_tpu_torch", "__init__.py")
    assert "keras" not in _imported_roots(init) | _init_names(init)


_KERAS_PROBE = """
import sys
if sys.argv[1] == "block":
    for m in ("jax", "jaxlib", "flax", "optax"):
        sys.modules[m] = None
try:
    import bluefog_tpu_torch.keras as bfk
except ImportError as exc:
    print("refused:", exc)
    raise SystemExit(0)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "bluefog_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("clean", sorted(bfk.__all__))
"""


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_keras_frontend_imports_with_jax_blocked(backend):
    """On the torch backend the frontend imports with JAX blocked and loads
    nothing of JAX (keras brings ``ml_dtypes``, which the card's machine,
    without keras, never loads); on any other backend it refuses with
    ImportError, as JAX's does off the jax backend (keras's numpy backend
    needs JAX, so that child runs unblocked)."""
    if importlib.util.find_spec("keras") is None:
        pytest.skip("keras is not installed")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KERAS_")}
    env.update(PYTHONPATH=_REPO, KERAS_BACKEND=backend,
               TF_CPP_MIN_LOG_LEVEL="3")
    block = "block" if backend == "torch" else "open"
    res = subprocess.run([sys.executable, "-c", _KERAS_PROBE, block],
                         cwd=_REPO,
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    last = res.stdout.splitlines()[-1]
    if backend == "torch":
        assert last == "clean ['DistributedOptimizer', " \
            "'broadcast_variables']"
    else:
        assert last == ("refused: bluefog_tpu_torch.keras needs the Keras "
                        "torch backend; set KERAS_BACKEND=torch before "
                        "importing keras (got 'numpy')")


def test_launcher_launch_paths_and_launch_helper_import_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BFT_", "MASTER_"))
           and k not in ("WORLD_SIZE", "RANK")}
    env.update(PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _LAUNCH_PROBE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.splitlines()[-1] == "clean"
    assert "control plane sharded over 2 server(s)" in res.stderr


def test_chip_smoke_binds_each_top_level_name_once():
    """A second ``def`` of a name in ``chip_smoke.py`` silently replaces the
    first, and the earlier phase that calls it fails only on the card."""
    import ast
    import collections

    with open(os.path.join(_REPO, "chip_smoke.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = collections.Counter(
        node.name for node in tree.body
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)))
    names.update(t.id for node in tree.body if isinstance(node, ast.Assign)
                 for t in node.targets if isinstance(t, ast.Name))
    assert [n for n, c in names.items() if c > 1] == []


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
    "ServeClient": lambda: bft.ServeClient([("127.0.0.1", 1)]),
    "serve_client": lambda: bft.serve_client(
        endpoints=[("127.0.0.1", 1)]),
    "serving.main": lambda: serving.main([]),
    "launcher --serve": lambda: launcher.main(
        ["--serve", "--cp", "127.0.0.1:1"]),
    "keras_mnist.main": lambda: keras_mnist.main([]),
    "scaling.record_train_step": lambda: scaling.record_train_step(
        "allreduce", 8),
    "scaling.record_cp_forward": lambda: scaling.record_cp_forward(8),
    "scaling.record_moe_lm_grad": lambda: scaling.record_moe_lm_grad(8),
    "scaling.main": lambda: scaling.main(["--out", os.devnull]),
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
    # the window optimizers (Queue 1, item 6(c))
    "DistributedWinPutOptimizer", "DistributedPullGetOptimizer",
    "DistributedPushSumOptimizer",
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
_NOT_YET = {"parallel": set(), "utils": set(), "top": set()}


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
    assert len(_NOT_YET["top"]) == 0
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
