"""The system under test, built for a configuration's family: each module
here builds the port's normal path (``bf.init``, the model, the
optimizer under ``DistributedNeighborAllreduceOptimizer``) and loads the
benchmark's weights into it. ``build(cell, W, device)`` returns a ``Job``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch


@dataclass
class Job:
    opt: object                                  # the port's optimizer
    leaves: List[Tuple[str, torch.nn.Parameter]]  # benchmark name, parameter
    close: Callable[[], None]


def base_optimizer(params, spec: dict) -> torch.optim.Optimizer:
    """The cell's ``torch.optim`` optimizer, as a user of the port builds it."""
    if spec["name"] == "adam":
        return torch.optim.Adam(params, lr=spec["lr"], betas=tuple(spec["betas"]),
                                eps=spec["eps"])
    if spec["name"] == "sgd":
        return torch.optim.SGD(params, lr=spec["lr"], momentum=spec["momentum"])
    raise ValueError(f"unknown optimizer {spec['name']!r}")


def first_gradient(opt: torch.optim.Optimizer, p: torch.Tensor,
                   spec: dict) -> torch.Tensor:
    """The gradient the optimizer got at its first step, worked out from its
    state after that step (zeros where it holds none)."""
    state = opt.state.get(p, {})
    if spec["name"] == "adam" and "exp_avg" in state:
        return state["exp_avg"] / (1.0 - spec["betas"][0])
    if spec["name"] == "sgd" and state.get("momentum_buffer") is not None:
        return state["momentum_buffer"]
    return torch.zeros_like(p)


def init_world(job: dict, device: torch.device) -> None:
    """``bf.init`` over the cell's topology."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology

    def graph(n: int):
        if n == 1:
            return topology.FullyConnectedGraph(1)
        if job["topology"] == "exp2":
            return topology.ExponentialTwoGraph(n)
        raise ValueError(f"unknown topology {job['topology']!r}")
    bf.init(topology_fn=graph, device=device)


def load(model: torch.nn.Module, W: dict, names: dict) -> None:
    """Copy the benchmark's weights ``W`` into ``model`` through
    ``names`` (benchmark name -> the model's parameter name)."""
    state = model.state_dict()
    for bench, prog in names.items():
        state[prog] = W[bench]
    model.load_state_dict(state, strict=True)
