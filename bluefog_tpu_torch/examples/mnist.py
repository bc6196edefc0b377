"""Decentralized MNIST training.

The port of ``examples/mnist.py`` (the reference's
``examples/pytorch_mnist.py``): the LeNet-5 conv net, each rank training on
its own shard of a synthetic MNIST-shaped dataset (noisy class templates:
nothing is downloaded), the parameters mixed by the chosen distributed
optimizer around SGD with momentum.

Run at world 4 on the CPU (one process per rank):

    torchrun --standalone --nproc_per_node 4 \\
        -m bluefog_tpu_torch.examples.mnist --device cpu --epochs 1
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

import bluefog_tpu_torch as bf

OPTIMIZERS = {
    "neighbor_allreduce": bf.DistributedNeighborAllreduceOptimizer,
    "allreduce": bf.DistributedAllreduceOptimizer,
    "gradient_allreduce": bf.DistributedGradientAllreduceOptimizer,
}


def synthetic_mnist(n_per_rank: int, size: int, seed: int = 0):
    """Class-structured fake MNIST: digits are noisy class-template images.
    Returns every rank's images ``[size, n, 28, 28]`` and labels."""
    rng = np.random.RandomState(seed)
    templates = rng.rand(10, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, (size, n_per_rank))
    images = templates[labels] + 0.3 * rng.randn(
        size, n_per_rank, 28, 28).astype(np.float32)
    return images.astype(np.float32), labels.astype(np.int64)


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--dist-optimizer", default="neighbor_allreduce",
                   choices=sorted(OPTIMIZERS))
    p.add_argument("--samples-per-rank", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    bf.init(device=args.device)
    try:
        return _train(args, torch.device(args.device))
    finally:
        bf.shutdown()


def _train(args, dev: torch.device) -> float:
    """Trains, prints each epoch's mean loss and the consensus model's
    accuracy on rank 0's shard (rank 0 prints), and returns the accuracy."""
    n, me = bf.size(), bf.rank()
    model = bf.models.LeNet5(device=dev, seed=42)
    opt = OPTIMIZERS[args.dist_optimizer](
        torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9), model,
        bf.models.classification_loss)
    images, labels = synthetic_mnist(args.samples_per_rank, n)
    mine = (torch.from_numpy(images[me]).to(dev),
            torch.from_numpy(labels[me]).to(dev))
    steps = args.samples_per_rank // args.batch_size
    for epoch in range(args.epochs):
        total = torch.zeros((), device=dev)
        for s in range(steps):
            lo, hi = s * args.batch_size, (s + 1) * args.batch_size
            total += opt.step((mine[0][lo:hi], mine[1][lo:hi]))["loss"]
        dist.all_reduce(total)
        if me == 0:
            print(f"epoch {epoch}: mean loss {float(total) / (n * steps):.4f}",
                  flush=True)

    # evaluate the consensus model (every rank's copy after a final average)
    # on rank 0's shard
    bf.allreduce_parameters(model)
    with torch.no_grad():
        logits = model(torch.from_numpy(images[0]).to(dev))
    acc = float((logits.argmax(-1).cpu() == torch.from_numpy(labels[0]))
                .float().mean())
    if me == 0:
        print(f"train-shard accuracy of consensus model: {acc:.3f}",
              flush=True)
    return acc


if __name__ == "__main__":
    main()
