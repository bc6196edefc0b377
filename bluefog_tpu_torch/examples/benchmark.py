"""Throughput benchmark: the port of ``examples/benchmark.py``.

The reference's harness (``examples/pytorch_benchmark.py``, its argument
surface at :52-60): synthetic data, warm-up, then timed iterations of
``--num-batches-per-iter`` batches, and img/sec mean +- CI. One model
replica per rank (one process each), the chosen distributed optimizer doing
the communication around SGD (0.01, momentum 0.9). The dynamic Expo-2
one-peer schedule is on by default, as in the reference
(``--disable-dynamic-topology`` keeps the static graph).

Run on one card:                 python -m bluefog_tpu_torch.examples.benchmark
At world 4 on the CPU:
    torchrun --standalone --nproc_per_node 4 \\
        -m bluefog_tpu_torch.examples.benchmark --device cpu --model mlp \\
        --batch-size 8 --num-warmup-batches 1 --num-batches-per-iter 2 \\
        --num-iters 2

``--dist-optimizer win_put``, ``push_sum`` and ``pull_get`` run on the
one-sided windows, which the port does not have yet (they raise).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import bluefog_tpu_torch as bf

WINDOW_KINDS = ("win_put", "push_sum", "pull_get")
OPTIMIZERS = {
    "neighbor_allreduce": bf.DistributedNeighborAllreduceOptimizer,
    "allreduce": bf.DistributedAllreduceOptimizer,
    "gradient_allreduce": bf.DistributedGradientAllreduceOptimizer,
    "sharded_allreduce": bf.DistributedShardedAllreduceOptimizer,
    "hierarchical_neighbor_allreduce":
        bf.DistributedHierarchicalNeighborAllreduceOptimizer,
    "local": bf.DistributedNeighborAllreduceOptimizer,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="resnet50",
                   choices=["resnet50", "resnet34", "resnet18", "vgg16",
                            "mlp", "lm"])
    p.add_argument("--batch-size", type=int, default=64,
                   help="per-chip batch size")
    p.add_argument("--num-warmup-batches", type=int, default=10)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=10)
    p.add_argument("--dist-optimizer", default="neighbor_allreduce",
                   choices=[*OPTIMIZERS, *WINDOW_KINDS])
    p.add_argument("--disable-dynamic-topology", action="store_true",
                   help="use the static topology instead of the one-peer "
                        "dynamic Expo-2 schedule")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def make_model(args, dev):
    """``(model, batch, loss_fn)``: this rank's synthetic batch on ``dev``
    (normal images and labels 0, or random tokens for the LM)."""
    gen = torch.Generator(device=dev).manual_seed(bf.rank())
    b = args.batch_size
    if args.model == "lm":
        # LM-shaped parameters: embedding, attention blocks, norms
        model = bf.models.TransformerLM(
            vocab_size=512, num_layers=2, num_heads=4, d_model=128,
            d_ff=512, device=dev)
        tokens = torch.randint(0, 512, (b, 32), generator=gen, device=dev)
        return model, (tokens, torch.zeros_like(tokens)), bf.models.lm_loss
    if args.model == "mlp":
        model = bf.models.MLP(in_features=32 * 32 * 3,
                              features=(512, 512, 10), device=dev)
        shape = (b, 32, 32, 3)
    elif args.model == "vgg16":
        model = bf.models.VGG16(num_classes=1000, dtype=torch.bfloat16,
                                image_size=args.image_size, device=dev)
        shape = (b, args.image_size, args.image_size, 3)
    else:
        cls = {"resnet50": bf.models.ResNet50, "resnet34": bf.models.ResNet34,
               "resnet18": bf.models.ResNet18}[args.model]
        model = cls(num_classes=1000, dtype=torch.bfloat16, device=dev)
        shape = (b, args.image_size, args.image_size, 3)
    images = torch.randn(shape, generator=gen, device=dev)
    labels = torch.zeros(b, dtype=torch.int64, device=dev)
    return model, (images, labels), bf.models.classification_loss


def dynamic_schedule(opt, n: int):
    """The one-peer dynamic Expo-2 schedule: each call sets the next round's
    send neighbors and uniform weights on ``opt`` (every rank computes every
    rank's, the global form the optimizer takes)."""
    gens = [bf.topology_util.GetDynamicSendRecvRanks(bf.load_topology(), r)
            for r in range(n)]

    def advance() -> None:
        sends = {r: next(g)[0] for r, g in enumerate(gens)}
        recv_from = {r: [] for r in range(n)}
        for s, dsts in sends.items():
            for d in dsts:
                recv_from[d].append(s)
        opt.send_neighbors = sends
        opt.self_weight = {r: 1.0 / (len(recv_from[r]) + 1)
                           for r in range(n)}
        opt.neighbor_weights = {
            r: {s: 1.0 / (len(recv_from[r]) + 1) for s in recv_from[r]}
            for r in range(n)}

    return advance


def main(argv=None) -> float:
    """Runs the benchmark; returns the mean img/sec over the ranks."""
    args = parse_args(argv)
    if args.dist_optimizer in WINDOW_KINDS:
        raise NotImplementedError(
            f"--dist-optimizer {args.dist_optimizer} runs on the one-sided "
            "windows, which the PyTorch port does not have yet: ROADMAP.md "
            "Queue 1, item 6 (windows and push-sum)")
    bf.init(device=args.device)
    try:
        return _run(args, torch.device(args.device))
    finally:
        bf.shutdown()


def _run(args, dev) -> float:
    n, me = bf.size(), bf.rank()
    model, batch, loss_fn = make_model(args, dev)
    opt = OPTIMIZERS[args.dist_optimizer](
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9), model,
        loss_fn)
    if args.dist_optimizer == "local":
        opt.num_steps_per_communication = 10**9
    dynamic = (not args.disable_dynamic_topology and
               args.dist_optimizer == "neighbor_allreduce" and n > 1)
    advance = dynamic_schedule(opt, n) if dynamic else None
    last = [None]

    def one_step() -> None:
        if advance:
            advance()
        last[0] = opt.step(batch)["loss"]

    def sync() -> None:
        # the loss on the host: the device has finished the step
        float(last[0])

    def say(*a) -> None:
        if me == 0:
            print(*a, flush=True)

    say(f"Model: {args.model}, batch {args.batch_size}/chip, {n} chip(s), "
        f"optimizer={args.dist_optimizer}, dynamic_topology={dynamic}")
    for _ in range(args.num_warmup_batches):
        one_step()
    sync()

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            one_step()
        sync()
        dt = time.perf_counter() - t0
        rate = args.batch_size * args.num_batches_per_iter * n / dt
        img_secs.append(rate)
        say(f"Iter #{i}: {rate:.1f} img/sec total")
    mean = float(np.mean(img_secs))
    conf = 1.96 * float(np.std(img_secs))
    say(f"Total img/sec on {n} chip(s): {mean:.1f} +-{conf:.1f}")
    return mean


if __name__ == "__main__":
    main()
