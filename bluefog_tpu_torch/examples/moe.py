"""Expert-parallel Mixture-of-Experts training.

The port of ``examples/moe.py``. It trains a Switch-FFN classifier expert
parallel: one expert per rank, each rank's tokens dispatched to their
experts with all-to-all (``bluefog_tpu_torch.parallel.ep_apply``, which is
differentiable: the gate learns through the top-1 probability scaling).
Then the MoE transformer LM with its experts on the ranks
(``ep_lm_loss_fn``). Both train with plain Adam: a decentralized optimizer
would average parameters across ranks and mix different experts.

Run at world 4 on the CPU (one process per rank, one expert each):

    torchrun --standalone --nproc_per_node 4 \\
        -m bluefog_tpu_torch.examples.moe --device cpu --experts 4

On one card, ``--experts 1``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import parallel as bfp
from bluefog_tpu_torch.models import MoETransformerLM


def make_data(seed: int = 0, n_clusters: int = 8, per: int = 64,
              d: int = 16):
    """Clustered inputs: an ideal router sends each cluster to one expert.
    Returns ``x [n_clusters * per, d]`` (f32) and the labels."""
    rng = np.random.RandomState(seed)
    centers = rng.standard_normal((n_clusters, d)) * 3.0
    x = centers[:, None, :] + 0.3 * rng.standard_normal((n_clusters, per, d))
    y = np.repeat(np.arange(n_clusters), per)
    return x.reshape(-1, d).astype(np.float32), y


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--aux-weight", type=float, default=0.01)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    bf.init(device=args.device)
    try:
        _train(args)
    finally:
        bf.shutdown()


def _global(local: torch.Tensor) -> float:
    """The sum over the ranks of each rank's share of the loss."""
    total = local.detach().clone()
    dist.all_reduce(total)
    return float(total)


def _train(args) -> None:
    n, me = bf.size(), bf.rank()
    E, d, d_ff, classes, per = args.experts, 16, 64, 8, 64
    tokens = classes * per
    if E != n or tokens % E:
        raise SystemExit(
            f"--experts {E} must equal the {n} ranks (one expert per rank) "
            f"and divide the {tokens}-token dataset")
    dev = torch.device(args.device)   # cuda: the card init selected

    def say(*a) -> None:
        if me == 0:
            print(*a, flush=True)

    say(f"experts: {E} on {dev.type}")
    x, y = make_data(n_clusters=classes, per=per, d=d)
    # [B, S, d] with B = E, one row per rank
    bx = torch.from_numpy(x.reshape(E, -1, d)[me:me + 1]).to(dev)
    by = torch.from_numpy(y.reshape(E, -1)[me:me + 1]).to(dev)

    # every rank holds the full weights from one seed; ep_apply uses gate
    # and this rank's expert, whose rows alone get a gradient here
    moe = bfp.SwitchFFN(d, E, d_ff, device=dev, seed=1)
    params = {"gate": moe.gate, "up": moe.up, "down": moe.down}
    gen = torch.Generator(device=dev).manual_seed(2)
    head = torch.nn.Parameter(
        torch.randn((d, classes), generator=gen, device=dev) * 0.1)
    opt = torch.optim.Adam([*moe.parameters(), head], lr=3e-2)

    losses = []
    for step in range(args.steps):
        opt.zero_grad(set_to_none=True)
        h, aux = bfp.ep_apply(params, bx, capacity_factor=4.0)
        logits = (bx + h) @ head          # residual MoE + linear head
        ce = F.cross_entropy(logits.reshape(-1, classes), by.reshape(-1))
        # this rank's share of the mean over the ranks (equal local batches)
        local = (ce + args.aux_weight * aux) / n
        local.backward()
        # the head is replicated: its gradient sums the ranks' shares, as
        # ep_apply sums the gate's
        dist.all_reduce(head.grad)
        opt.step()
        losses.append(_global(local))
        if step % 10 == 0:
            say(f"step {step:3d}  loss {losses[-1]:.4f}")

    say(f"final loss: {losses[-1]:.4f} (from {losses[0]:.4f})")
    if not losses[-1] < 0.5 * losses[0]:
        raise SystemExit("MoE training failed to converge")
    say("MOE OK")

    # ---- part 2: the MoE transformer LM, experts on the ranks ----
    lm = MoETransformerLM(
        vocab_size=64, num_experts=E, num_layers=2, num_heads=2, d_model=32,
        d_ff=d_ff, expert_axis="expert", device=dev, seed=8)
    toks = np.random.RandomState(7).randint(0, 64, (E, 16))
    toks = torch.from_numpy(toks[me:me + 1]).to(dev)
    batch = (toks, toks.roll(-1, dims=1))
    loss_fn = bfp.ep_lm_loss_fn(lm, aux_weight=args.aux_weight)
    lm_opt = torch.optim.Adam(lm.parameters(), lr=3e-3)
    lm_losses = []
    for step in range(args.steps):
        lm_opt.zero_grad(set_to_none=True)
        loss = loss_fn(lm, batch)
        loss.backward()
        lm_opt.step()
        lm_losses.append(float(loss.detach()))
        if step % 20 == 0:
            say(f"lm step {step:3d}  loss {lm_losses[-1]:.4f}")
    say(f"lm final loss: {lm_losses[-1]:.4f} (from {lm_losses[0]:.4f})")
    if not lm_losses[-1] < 0.7 * lm_losses[0]:
        raise SystemExit("MoE LM failed to converge")
    say("MOE_LM OK")


if __name__ == "__main__":
    main()
