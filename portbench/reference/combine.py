"""The combine of a world of more than one rank, written out.

Each rank's parameters become the uniform mean of its own and its
in-neighbours' in the cell's graph, as BlueFog's ``neighbor_allreduce``
defines it with uniform weights. In the Exponential-2 graph of n ranks,
rank r sends to r + 2^k and hears r - 2^k (mod n) for every 2^k < n: at
n = 4, two in-neighbours and the weights 1/3. Plain ``torch.distributed``
over the benchmark's own process group, one leaf at a time.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.distributed as dist


def distances(topology: str, n: int) -> List[int]:
    if topology != "exp2":
        raise ValueError(f"unknown topology {topology!r}")
    return sorted({2 ** k % n for k in range(n.bit_length()) if 2 ** k < n})


def neighbour_mean(topology: str, rank: int, n: int) -> Callable:
    """``average(W)``: ``W`` in place, each leaf the mean over this rank and
    its in-neighbours."""
    hops = distances(topology, n)

    @torch.no_grad()
    def average(W: Dict[str, torch.Tensor]) -> None:
        for p in W.values():
            mine = p.detach().contiguous()
            heard = [torch.empty_like(mine) for _ in hops]
            ops = [dist.P2POp(dist.isend, mine, (rank + h) % n) for h in hops]
            ops += [dist.P2POp(dist.irecv, buf, (rank - h) % n)
                    for buf, h in zip(heard, hops)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            p.copy_(sum(heard, mine.clone()) / (len(hops) + 1))
    return average
