"""Run one cell of the benchmark and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout, on the machine it is started on, with the
chips the cell asks for. The kernels' builds and caches live in fixed
folders inside the checkout (``bluefog_tpu_torch/_build`` and
``.portbench_cache``), so only a checkout's first run builds. Python's
bytecode is one of those caches (``.portbench_cache/pyc``), written even
where the environment says not to (``PYTHONDONTWRITEBYTECODE``), so that
no run but the first compiles torch's sources on import. The last lines
on standard error, and the ``checks`` key that ends the result line, give
each number the output check compared beside its limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "bluefog_tpu")


def _caches() -> None:
    """The caches' folders, for this process and those it starts."""
    cache = os.path.join(ROOT, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("PYTHONPYCACHEPREFIX", "pyc")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
    sys.dont_write_bytecode = False


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    _caches()
    sys.path[0] = ROOT          # the checkout, not this folder
    from portbench.spec import Spec

    cell = Spec(ROOT).cell(args.workload)
    # the deployment's settings, before torch reads them
    os.environ.update(cell.job.get("env", {}))
    import torch
    torch_s = time.perf_counter() - T0

    from portbench import harness, world

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if int(cell.job["world"]) > 1:
        result, timing = world.launch(
            args.workload, args.seed, args.seconds, bool(args.trace),
            int(cell.job["world"]),
            started=time.time() - (time.perf_counter() - T0))
    else:
        result, timing = harness.run(args.workload, args.seed, args.seconds,
                                     bool(args.trace), t0=T0)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    timing = {"torch_s": torch_s, **timing}
    print(" ".join(f"{k} {v:.3f}" for k, v in timing.items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
