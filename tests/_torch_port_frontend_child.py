"""The torch frontend's world-N scenarios, one rank of them
(``tests/_torch_port_child.py`` mode ``frontend``).

Each rank builds its module from row ``rank`` of the seeded inputs, runs
the counterparts of ``tests/test_torch_frontend.py`` through
``bluefog_tpu_torch.torch_frontend`` and returns its arrays; the test runs
JAX's ``bluefog_tpu.torch`` on the same inputs over all ranks in one
process. The small flash ``TransformerLM`` trains twice from one seed: in
a user's loop under ``DistributedTorchOptimizer``, and through
``DistributedNeighborAllreduceOptimizer.step(batch)``. It imports the port
only, never JAX.
"""

from __future__ import annotations

import numpy as np


def linear(torch, inp, rank: int):
    """Rank ``rank``'s ``Linear(4, 2)`` with the seeded weights."""
    m = torch.nn.Linear(4, 2)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(inp["w"][rank]))
        m.bias.copy_(torch.from_numpy(inp["b"][rank]))
    return m


def _weights(m) -> np.ndarray:
    return np.concatenate([m.weight.detach().numpy().ravel(),
                           m.bias.detach().numpy().ravel()])


def train_linear(torch, bft, inp, rank: int, make_opt, steps: int,
                 every: int = 1) -> np.ndarray:
    """``steps`` user-loop steps of rank ``rank``'s module on its own
    ``x[rank]``; the flat weights after each step, ``[steps, 10]``."""
    m = linear(torch, inp, rank)
    opt = bft.DistributedTorchOptimizer(make_opt(m.parameters()), m,
                                        num_steps_per_communication=every)
    x = torch.from_numpy(inp["x"][rank])
    trail = []
    for _ in range(steps):
        opt.zero_grad()
        m(x).square().mean().backward()
        opt.step()
        trail.append(_weights(m))
    return np.stack(trail)


def lm_runs(bf, torch, inp, rank: int, steps: int) -> dict:
    """The small flash LM (the plain K1-K3 on the CPU) trained from one seed
    in a user's loop and through ``step(batch)``: each run's losses and
    final parameters."""
    from bluefog_tpu_torch import torch_frontend as bft
    from bluefog_tpu_torch.parallel.flash import flash_attention

    def model():
        return bf.models.TransformerLM(
            vocab_size=64, num_layers=2, num_heads=2, d_model=16, d_ff=32,
            attn_fn=flash_attention, device="cpu", seed=0)

    batch = (torch.from_numpy(inp["tokens"][rank]).long(),
             torch.from_numpy(inp["targets"][rank]).long())
    out = {}
    m = model()
    opt = bft.DistributedTorchOptimizer(
        torch.optim.Adam(m.parameters(), lr=1e-2), m)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = bf.models.lm_loss(m, batch)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    out["user_losses"] = np.asarray(losses)
    out.update({f"user:{k}": v.detach().numpy()
                for k, v in m.named_parameters()})
    m = model()
    opt = bf.DistributedNeighborAllreduceOptimizer(
        torch.optim.Adam(m.parameters(), lr=1e-2), m, bf.models.lm_loss)
    out["fused_losses"] = np.asarray(
        [float(opt.step(batch)["loss"]) for _ in range(steps)])
    out.update({f"fused:{k}": v.detach().numpy()
                for k, v in m.named_parameters()})
    return out


def frontend(bf, torch, rank: int, world: int, inp) -> dict:
    from bluefog_tpu_torch import torch_frontend as bft

    n = world
    x = torch.from_numpy(inp["v"][rank])
    out = {}
    # the ops, once each (this rank's tensor in, this rank's result out)
    out["allreduce"] = bft.allreduce(x).numpy()
    out["neighbor_allreduce"] = bft.neighbor_allreduce(x).numpy()
    out["broadcast"] = bft.broadcast(x, root_rank=2).numpy()
    out["allgather"] = bft.allgather(x).numpy()
    out["neighbor_allgather"] = bft.neighbor_allgather(x).numpy()
    out["dynamic"] = bft.neighbor_allreduce(
        x, self_weight=0.5,
        neighbor_weights={r: {(r - 1) % n: 0.5} for r in range(n)},
        send_neighbors={r: [(r + 1) % n] for r in range(n)}).numpy()
    assert bft.win_create(x, "f.win", zero_init=True)
    bft.win_put(x, "f.win")
    out["win_update"] = bft.win_update("f.win").numpy()
    bft.win_free("f.win")
    out["owned_ranks"] = np.asarray(bft.owned_ranks())

    # DistributedTorchOptimizer: SGD, Adam, and N = 2 steps a mixing
    out["sgd"] = train_linear(torch, bft, inp, rank,
                              lambda ps: torch.optim.SGD(ps, lr=0.05), 6)
    out["adam"] = train_linear(torch, bft, inp, rank,
                               lambda ps: torch.optim.Adam(ps, lr=0.01), 6)
    out["every2"] = train_linear(torch, bft, inp, rank,
                                 lambda ps: torch.optim.SGD(ps, lr=0.05), 4,
                                 every=2)

    # broadcast_parameters from rank 2
    m = linear(torch, inp, rank)
    bft.broadcast_parameters(m, root_rank=2)
    out["bcast_params"] = _weights(m)

    # broadcast_optimizer_state: divergent momenta replaced by rank 1's
    m = linear(torch, inp, rank)
    opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
    (m(torch.full((4, 4), float(rank + 1))) ** 2).mean().backward()
    opt.step()
    before = opt.state[m.weight]["momentum_buffer"].clone()
    out["momentum_before"] = before.numpy()
    bft.broadcast_optimizer_state(opt, m, root_rank=1)
    out["momentum_after"] = opt.state[m.weight]["momentum_buffer"].numpy()

    # Adam's 0-dim step: its own tensor per parameter, advancing once a step
    m = linear(torch, inp, rank)
    opt = torch.optim.Adam(m.parameters(), lr=0.01)
    xs = torch.from_numpy(inp["x"][rank][:4])
    ((m(xs) * (rank + 1)) ** 2).mean().backward()
    opt.step()
    bft.broadcast_optimizer_state(opt, m, root_rank=0)
    steps = [opt.state[p]["step"] for p in m.parameters()]
    out["adam_steps_distinct"] = np.asarray(len({id(s) for s in steps}))
    for _ in range(2):
        opt.zero_grad()
        ((m(xs) * (rank + 1)) ** 2).mean().backward()
        opt.step()
    out["adam_steps"] = np.asarray([float(opt.state[p]["step"])
                                    for p in m.parameters()])
    out.update(lm_runs(bf, torch, inp, rank, int(inp["lm_steps"])))
    return out
