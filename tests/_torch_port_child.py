"""One rank of the PyTorch port's world-N tests (gloo over a FileStore).

The parent test calls :func:`run_world`, which starts ``world`` copies of
this file as separate processes, one per rank:

    python _torch_port_child.py <mode> <rank> <world> <dir>

Each child joins the process group through ``<dir>/store``, reads its
inputs from ``<dir>/inputs.npz`` (made by the parent with numpy from a
seed), runs ``<mode>`` through the port, and writes ``<dir>/out_<rank>.npz``.
The children import the port only, never JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(mode: str, tmp_dir: str, world: int = 4,
              timeout: float = 300.0):
    """Run ``mode`` on ``world`` child ranks; returns each rank's outputs."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         tmp_dir], env=env, cwd=tmp_dir, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {mode} failed:\n{logs[r]}")
    return [dict(np.load(os.path.join(tmp_dir, f"out_{r}.npz")))
            for r in range(world)]


def _ops(bf, torch, rank: int, world: int, inp) -> dict:
    x = torch.from_numpy(inp["x"][rank])
    n = world
    out = {"static": bf.neighbor_allreduce(x)}
    nested = {r: {(r - 1) % n: 0.3, (r - 2) % n: 0.2} for r in range(n)}
    out["weighted"] = bf.neighbor_allreduce(
        x, self_weight=0.5, neighbor_weights=nested)
    out["dynamic"] = bf.neighbor_allreduce(
        x, self_weight=0.5,
        neighbor_weights={r: {(r - 1) % n: 0.5} for r in range(n)},
        send_neighbors={r: [(r + 1) % n] for r in range(n)})
    out["gather"] = bf.neighbor_allreduce(x, force_gather=True)
    out["bf16"] = bf.neighbor_allreduce(x.to(torch.bfloat16)).float()
    out["allreduce_avg"] = bf.allreduce(x)
    out["allreduce_sum"] = bf.allreduce(x, average=False)
    out["broadcast"] = bf.broadcast(x, root_rank=2)
    bf.set_topology(bf.topology_util.RingGraph(n), is_weighted=True)
    out["weighted_topo"] = bf.neighbor_allreduce(x)
    return {k: v.numpy() for k, v in out.items()}


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *mods, leaf = key.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = val
    return tree


def _slice(bf, torch, rank: int, world: int, inp) -> dict:
    from bluefog_tpu_torch.parallel.flash import flash_attention
    from bluefog_tpu_torch.utils import params_from_jax

    cfg = {k: int(inp[k]) for k in ("vocab", "layers", "heads", "d_model",
                                    "d_ff")}
    model = bf.models.TransformerLM(
        vocab_size=cfg["vocab"], num_layers=cfg["layers"],
        num_heads=cfg["heads"], d_model=cfg["d_model"], d_ff=cfg["d_ff"],
        attn_fn=flash_attention, device="cpu")
    params = {k[len("p:"):]: v for k, v in inp.items() if k.startswith("p:")}
    model.load_state_dict(params_from_jax(_unflatten(params)))
    opt = bf.DistributedNeighborAllreduceOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), model,
        bf.models.lm_loss)
    tokens = torch.from_numpy(inp["tokens"][rank]).long()
    targets = torch.from_numpy(inp["targets"][rank]).long()
    losses = [float(opt.step((tokens, targets))["loss"])
              for _ in range(int(inp["steps"]))]
    out = {f"sd:{k}": v.detach().numpy() for k, v in
           model.state_dict().items()}
    out["losses"] = np.asarray(losses)
    return out


def _vision(bf, torch, rank: int, world: int, inp) -> dict:
    """ResNet18 under DistributedNeighborAllreduceOptimizer around SGD
    (lr 0.1, momentum 0.9), this rank's images; the flax variables come in
    as ``v:<collection>/<path>`` leaves."""
    from bluefog_tpu_torch.utils import params_from_jax

    model = bf.models.ResNet18(num_filters=int(inp["num_filters"]),
                               num_classes=int(inp["num_classes"]),
                               dtype=torch.float32, device="cpu")
    variables = {k[len("v:"):]: v for k, v in inp.items()
                 if k.startswith("v:")}
    model.load_state_dict(params_from_jax(_unflatten(variables)))
    opt = bf.DistributedNeighborAllreduceOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), model,
        bf.models.classification_loss)
    batch = (torch.from_numpy(inp["images"][rank]),
             torch.from_numpy(inp["labels"][rank]))
    losses = [float(opt.step(batch)["loss"])
              for _ in range(int(inp["steps"]))]
    out = {f"sd:{k}": v.detach().numpy() for k, v in
           model.state_dict().items()}
    out["losses"] = np.asarray(losses)
    return out


def main() -> None:
    mode, rank, world, tmp_dir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    import torch

    import bluefog_tpu_torch as bf

    torch.set_num_threads(1)
    bf.init(device="cpu", init_method="file://" + os.path.join(
        tmp_dir, "store"), rank=rank, world_size=world)
    inp = dict(np.load(os.path.join(tmp_dir, "inputs.npz")))
    out = {"ops": _ops, "slice": _slice, "vision": _vision}[mode](
        bf, torch, rank, world, inp)
    bf.barrier()
    bf.shutdown()
    np.savez(os.path.join(tmp_dir, f"out_{rank}.npz"), **out)


if __name__ == "__main__":
    main()
