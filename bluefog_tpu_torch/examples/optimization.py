"""Decentralized optimization algorithms on the port's BlueFog API.

The port of ``examples/optimization.py`` (the reference's
``examples/pytorch_optimization.py``): a regularized regression problem
whose data is partitioned across the ranks, solved by

  * diffusion                  (Sayed, "Adaptive networks", 2014)
  * exact diffusion            (Yuan et al., 2018, Alg. 1)
  * gradient tracking          (Nedic et al., 2017, Alg. 1)

and checked against the centralized optimum that distributed gradient
descent reaches. One process per rank: each holds its own ``X [m, n]``,
``y [m, 1]`` and iterate ``w [n, 1]``, and every communication round is one
collective of this rank's tensor. Gradient tracking keeps the reference's
overlap: two nonblocking ``neighbor_allreduce`` calls in flight while the
new local gradient is computed. Push-DIGing (``push_diging``) runs on the
one-sided windows (``win_accumulate``); its port is the examples' window
part, not done yet: it raises and names the roadmap item.

As in the JAX example, the l2 regularizer is the smooth
``0.5 * rho * ||w||^2``.

Run at world 4 on the CPU (one process per rank):

    torchrun --standalone --nproc_per_node 4 \\
        -m bluefog_tpu_torch.examples.optimization --device cpu \\
        --method gradient_tracking --task linear_regression --max-iter 200
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.func import grad

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.runtime.state import _global_state


# ---------------------------------------------------------------------------
# data + objective
# ---------------------------------------------------------------------------

def generate_data(seed: int, size: int, m: int, n: int,
                  task: str = "logistic_regression"):
    """Every rank's synthetic data from one numpy seed, rank-stacked:
    ``X [size, m, n]``, ``y [size, m, 1]`` (f32). Rank r uses row r."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((size, m, n))
    if task == "logistic_regression":
        w0 = rng.standard_normal((size, n, 1))
        p = 1.0 / (1.0 + np.exp(X @ w0))
        y = 2.0 * (rng.uniform(size=(size, m, 1)) < p) - 1.0
    elif task == "linear_regression":
        x_o = rng.standard_normal((size, n, 1))
        y = X @ x_o + 0.1 * rng.standard_normal((size, m, 1))
    else:
        raise NotImplementedError(
            "task must be linear_regression or logistic_regression")
    return X.astype(np.float32), y.astype(np.float32)


def make_grad_fn(X: torch.Tensor, y: torch.Tensor, task: str,
                 rho: float) -> Callable:
    """This rank's gradient: ``w [n, 1] -> grad [n, 1]`` of its local loss
    on its ``X [m, n]``, ``y [m, 1]``."""
    def local_loss(w):
        if task == "logistic_regression":
            data = torch.log1p(torch.exp(-y * (X @ w))).mean()
        else:
            r = X @ w - y
            data = 0.5 * (r * r).mean()
        return data + 0.5 * rho * (w * w).sum()

    return grad(local_loss)


def _zeros(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((n, 1), dtype=torch.float32, device=like.device)


def _err(w: torch.Tensor, w_opt: torch.Tensor) -> float:
    return float(torch.linalg.norm(w - w_opt))


# ---------------------------------------------------------------------------
# baseline: distributed gradient descent (the centralized optimum)
# ---------------------------------------------------------------------------

def distributed_grad_descent(grad_fn, size: int, n: int, maxite: int = 500,
                             alpha: float = 1e-1, like=None):
    """``x^{k+1} = x^k - alpha * allreduce(local_grad)``. ``like`` places the
    iterate (a tensor on the device; default the CPU)."""
    w = _zeros(n, like if like is not None else torch.zeros(()))
    for _ in range(maxite):
        g = bf.allreduce(grad_fn(w), average=True, name="gradient")
        w = w - alpha * g
    return w


# ---------------------------------------------------------------------------
# the decentralized algorithms; each returns this rank's final iterate and
# its distance to ``w_opt`` after every iteration
# ---------------------------------------------------------------------------

def diffusion(grad_fn, w_opt, size: int, n: int, maxite: int = 500,
              alpha: float = 1e-1) -> Tuple[torch.Tensor, List[float]]:
    """``w^{k+1} = neighbor_allreduce(w^k - alpha * grad)``."""
    w = _zeros(n, w_opt)
    mse = []
    for _ in range(maxite):
        phi = w - alpha * grad_fn(w)
        w = bf.neighbor_allreduce(phi, name="diffusion.w")
        mse.append(_err(w, w_opt))
    return w, mse


def _abar_weights(size: int):
    """Receive weights of (A + I)/2 for the current topology, for every
    rank (the global form ``neighbor_allreduce`` takes)."""
    topo = bf.load_topology()
    self_w: Dict[int, float] = {}
    nbr_w: Dict[int, Dict[int, float]] = {}
    for r in range(size):
        sw, nw = topology_util.GetRecvWeights(topo, r)
        self_w[r] = (sw + 1.0) / 2.0
        nbr_w[r] = {src: v / 2.0 for src, v in nw.items()}
    return self_w, nbr_w


def exact_diffusion(grad_fn, w_opt, size: int, n: int, maxite: int = 500,
                    alpha: float = 1e-1, use_Abar: bool = True):
    """The psi/phi/combine recursion of Yuan et al. 2018; with ``use_Abar``
    the combination matrix is (A + I)/2."""
    self_w, nbr_w = _abar_weights(size) if use_Abar else (None, None)
    w = _zeros(n, w_opt)
    psi_prev = w
    mse = []
    for _ in range(maxite):
        psi = w - alpha * grad_fn(w)
        phi = psi + w - psi_prev
        w = bf.neighbor_allreduce(phi, self_weight=self_w,
                                  neighbor_weights=nbr_w,
                                  name="exact_diffusion.w")
        psi_prev = psi
        mse.append(_err(w, w_opt))
    return w, mse


def gradient_tracking(grad_fn, w_opt, size: int, n: int, maxite: int = 500,
                      alpha: float = 1e-1):
    """Nedic et al. 2017, Alg. 1. The two ``neighbor_allreduce`` calls are
    issued nonblocking and stay in flight while the new local gradient is
    computed."""
    w = _zeros(n, w_opt)
    q = grad_fn(w)            # q^0 = grad(w^0)
    grad_prev = q
    mse = []
    for _ in range(maxite):
        w_handle = bf.neighbor_allreduce_nonblocking(w, name="gt.w")
        q_handle = bf.neighbor_allreduce_nonblocking(q, name="gt.q")
        w = bf.synchronize(w_handle) - alpha * q
        g = grad_fn(w)        # overlaps with the q exchange
        q = bf.synchronize(q_handle) + g - grad_prev
        grad_prev = g
        mse.append(_err(w, w_opt))
    return w, mse


def push_diging(grad_fn, w_opt, size: int, n: int, maxite: int = 500,
                alpha: float = 1e-1):
    """Nedic et al. 2017, Alg. 2, over one-sided windows: it needs
    ``win_create``/``win_accumulate``/``win_update_then_collect``."""
    raise NotImplementedError(
        "push_diging (over win_accumulate) is not ported yet: ROADMAP.md "
        "Queue 1, item 4 (the examples' window parts)")


ALGORITHMS = {
    "diffusion": diffusion,
    "exact_diffusion": exact_diffusion,
    "gradient_tracking": gradient_tracking,
    "push_diging": push_diging,
}


# ---------------------------------------------------------------------------
# the problem and the command line
# ---------------------------------------------------------------------------

def set_example_topology(name: str) -> None:
    size = bf.size()
    if name == "mesh":
        bf.set_topology(topology_util.MeshGrid2DGraph(size), is_weighted=True)
    elif name == "expo2":
        bf.set_topology(topology_util.ExponentialGraph(size))
    elif name == "star":
        bf.set_topology(topology_util.StarGraph(size), is_weighted=True)
    elif name == "ring":
        bf.set_topology(topology_util.RingGraph(size))
    else:
        raise NotImplementedError(
            "topology must be one of mesh, star, ring, expo2")


def run(method: str = "exact_diffusion", task: str = "logistic_regression",
        topology: str = "ring", maxite: int = 500, alpha: float = 1e-1,
        rho: float = 1e-2, m: int = 20, n: int = 5, seed: int = 123417,
        device=None):
    """Build the problem, solve it centrally and decentrally, report both
    (rank 0 prints). Returns this rank's ``(w, w_opt, mse)``. ``device``
    defaults to the one ``bf.init`` chose (the card unless it was asked
    for the CPU)."""
    size, me = bf.size(), bf.rank()
    if device is None:
        device = _global_state().device
    set_example_topology(topology)
    X, y = generate_data(seed, size, m, n, task=task)
    X, y = (torch.from_numpy(a[me]).to(device) for a in (X, y))
    grad_fn = make_grad_fn(X, y, task, rho)

    w_opt = distributed_grad_descent(grad_fn, size, n, maxite=maxite,
                                     alpha=alpha, like=X)
    g_opt = bf.allreduce(grad_fn(w_opt), average=True)
    local = float(torch.linalg.norm(grad_fn(w_opt)))
    if me == 0:
        print(f"[DG] global grad norm: {float(torch.linalg.norm(g_opt)):.3e} "
              f"local grad norm: {local:.3e}")

    w, mse = ALGORITHMS[method](grad_fn, w_opt, size, n, maxite=maxite,
                                alpha=alpha)
    g = bf.allreduce(grad_fn(w), average=True)
    if me == 0:
        print(f"[{method}] final ||w - w_opt||: {mse[-1]:.3e} "
              f"global grad norm: {float(torch.linalg.norm(g)):.3e}",
              flush=True)
    return w, w_opt, mse


def main(argv=None) -> List[float]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--method", default="exact_diffusion",
                        choices=sorted(ALGORITHMS))
    parser.add_argument("--task", default="logistic_regression",
                        choices=["logistic_regression", "linear_regression"])
    parser.add_argument("--topology", default="ring",
                        choices=["mesh", "star", "ring", "expo2"])
    parser.add_argument("--max-iter", type=int, default=500)
    parser.add_argument("--lr", type=float, default=1e-1)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    bf.init(device=args.device)
    try:
        if bf.rank() == 0:
            print(f"ranks: {bf.size()} on {torch.device(args.device).type}")
        _, _, mse = run(method=args.method, task=args.task,
                        topology=args.topology, maxite=args.max_iter,
                        alpha=args.lr, device=args.device)
    finally:
        bf.shutdown()
    return mse


if __name__ == "__main__":
    main()
