"""ResNet training: the port of ``examples/resnet.py``.

The training loop of the reference's ``examples/pytorch_resnet.py``: warm-up
and piecewise learning-rate decay, local steps between communication rounds
(``--batches-per-allreduce``), the per-batch dynamic topology, validation
accuracy averaged over the ranks, and checkpoint/resume (the port's
``bluefog_tpu_torch.checkpoint``). The dataset is a deterministic synthetic
CIFAR-shaped mixture (class-conditioned gaussians), so nothing is
downloaded. The learning rate is set on the optimizer before each step from
``make_lr_schedule``, as the reference does host-side (JAX compiles an
optax schedule into its step); its values are JAX's, in f32.

Run at world 4 on the CPU (one process per rank):

    torchrun --standalone --nproc_per_node 4 \\
        -m bluefog_tpu_torch.examples.resnet --device cpu --epochs 2 \\
        --batch-size 4 --steps-per-epoch 6 --classes 4

``--dist-optimizer win_put`` runs on the one-sided windows, which the port
does not have yet (it raises).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

import bluefog_tpu_torch as bf
from bluefog_tpu_torch.examples.benchmark import dynamic_schedule

OPTIMIZERS = {
    "neighbor_allreduce": bf.DistributedNeighborAllreduceOptimizer,
    "gradient_allreduce": bf.DistributedGradientAllreduceOptimizer,
    "allreduce": bf.DistributedAllreduceOptimizer,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="resnet18",
                   choices=["resnet18", "resnet34", "resnet50"])
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-rank training batch size")
    p.add_argument("--val-batch-size", type=int, default=32)
    p.add_argument("--base-lr", type=float, default=0.0125,
                   help="per-rank base learning rate (scaled by size)")
    p.add_argument("--warmup-epochs", type=float, default=5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=5e-5)
    p.add_argument("--batches-per-allreduce", type=int, default=1,
                   help="local steps per communication round")
    p.add_argument("--dist-optimizer", default="neighbor_allreduce",
                   choices=[*OPTIMIZERS, "win_put"])
    p.add_argument("--disable-dynamic-topology", action="store_true")
    p.add_argument("--checkpoint-format", default=None,
                   help="e.g. /tmp/ckpt-{epoch}; enables save per epoch")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint directory to resume from")
    p.add_argument("--steps-per-epoch", type=int, default=40,
                   help="synthetic-data batches per epoch")
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def synthetic_dataset(seed: int, n_ranks: int, batch: int, steps: int,
                      image_size: int, classes: int, centers=None):
    """Class-conditioned gaussian 'images': learnable, deterministic, tiny.

    Returns every rank's images ``[steps, n_ranks, batch, H, W, 3]``, the
    labels ``[steps, n_ranks, batch]`` and the class centers; each rank
    takes its own shard, like the reference's DistributedSampler split.
    Pass the TRAIN set's ``centers`` when building the validation set.
    """
    rng = np.random.RandomState(seed)
    if centers is None:
        centers = rng.standard_normal((classes, 3)) * 2.0
    labels = rng.randint(0, classes, (steps, n_ranks, batch))
    noise = rng.standard_normal((steps, n_ranks, batch, image_size,
                                 image_size, 3))
    images = centers[labels][:, :, :, None, None, :] + noise
    return images.astype(np.float32), labels.astype(np.int64), centers


def make_lr_schedule(args, size: int, steps_per_epoch: int):
    """Warm-up from 1x to size-x over ``warmup_epochs``, then /10 at the
    ABSOLUTE epochs 30/60/80 (the reference's ``adjust_learning_rate``,
    pytorch_resnet.py:305-325: the decay epochs do not shift by the
    warm-up). ``schedule(step) -> lr`` in f32, as JAX's optax
    ``linear_schedule`` and its ``jnp`` arithmetic compute it."""
    f32 = np.float32
    warmup_steps = max(int(args.warmup_epochs * steps_per_epoch), 1)
    init = args.base_lr * args.batches_per_allreduce
    peak = args.base_lr * size * args.batches_per_allreduce

    def schedule(step: int) -> float:
        if step < warmup_steps:
            # optax: (init - end) * (1 - count / steps) + end, the Python
            # floats taken to f32 where they meet the f32 count
            frac = f32(1) - f32(step) / f32(warmup_steps)
            lr = f32(init - peak) * frac + f32(peak)
        else:
            lr = f32(peak)
        n_decays = f32(sum(step >= e * steps_per_epoch for e in (30, 60, 80)))
        return float(lr * np.power(f32(10.0), -n_decays))

    return schedule


def build(args):
    """``bf.init``, the model and the optimizer wrapper, resumed from
    ``--resume-from`` when given. Returns ``(model, opt, schedule,
    start_epoch)``."""
    if args.dist_optimizer == "win_put":
        raise NotImplementedError(
            "--dist-optimizer win_put runs on the one-sided windows, which "
            "the PyTorch port does not have yet: ROADMAP.md Queue 1, item 6 "
            "(windows and push-sum)")
    bf.init(device=args.device)
    n = bf.size()
    dev = torch.device(args.device)
    model_cls = {"resnet18": bf.models.ResNet18,
                 "resnet34": bf.models.ResNet34,
                 "resnet50": bf.models.ResNet50}[args.model]
    model = model_cls(num_classes=args.classes, device=dev, seed=args.seed)
    schedule = make_lr_schedule(args, n, args.steps_per_epoch)
    base = torch.optim.SGD(model.parameters(), lr=schedule(0),
                           momentum=args.momentum, weight_decay=args.wd)
    opt = OPTIMIZERS[args.dist_optimizer](
        base, model, bf.models.classification_loss,
        num_steps_per_communication=args.batches_per_allreduce)
    start_epoch = 0
    if args.resume_from:
        opt, step = bf.checkpoint.restore(args.resume_from, opt)
        start_epoch = int(step)
        if bf.rank() == 0:
            print(f"resumed from {args.resume_from} at epoch {start_epoch}")
    return model, opt, schedule, start_epoch


def evaluate(model, images, labels, dev):
    """Validation accuracy of this rank's model on its shard, then the
    mean over the ranks (the reference allreduces the metric, :291-301).
    Returns ``(mean, per_rank)``."""
    model.eval()
    hits = 0.0
    with torch.no_grad():
        for x, y in zip(images, labels):
            logits = model(torch.from_numpy(x).to(dev))
            hits += float((logits.argmax(-1).cpu()
                           == torch.from_numpy(y)).float().mean())
    model.train()
    mine = torch.tensor([hits / len(images)], device=dev)
    per_rank = bf.allgather(mine).cpu().numpy()
    return float(per_rank.mean()), per_rank


def train(args):
    """The training loop (rank 0 prints each epoch). Returns the history
    ``[(mean loss, val acc)]`` of the epochs run, and the optimizer
    wrapper (its ``model``)."""
    model, opt, schedule, start_epoch = build(args)
    try:
        return _loop(args, model, opt, schedule, start_epoch)
    finally:
        bf.shutdown()


def _loop(args, model, opt, schedule, start_epoch):
    n, me = bf.size(), bf.rank()
    dev = torch.device(args.device)
    tr_images, tr_labels, centers = synthetic_dataset(
        args.seed, n, args.batch_size, args.steps_per_epoch,
        args.image_size, args.classes)
    va_images, va_labels, _ = synthetic_dataset(
        args.seed + 1, n, args.val_batch_size,
        max(args.steps_per_epoch // 4, 1), args.image_size, args.classes,
        centers=centers)
    dynamic = (not args.disable_dynamic_topology and n > 1 and
               args.dist_optimizer == "neighbor_allreduce")
    advance = dynamic_schedule(opt, n) if dynamic else None
    history = []
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        total = torch.zeros((), device=dev)
        # double-buffered host->device feeding: batch s+1 is on its way
        # while step s computes
        feed = bf.utils.prefetch_to_device(
            ((torch.from_numpy(tr_images[s, me]),
              torch.from_numpy(tr_labels[s, me]))
             for s in range(args.steps_per_epoch)), size=2, device=dev)
        for s in range(args.steps_per_epoch):
            if advance:
                advance()
            for group in opt.base.param_groups:
                group["lr"] = schedule(epoch * args.steps_per_epoch + s)
            total += opt.step(next(feed))["loss"]
        dist.all_reduce(total)
        loss = float(total) / (n * args.steps_per_epoch)
        val_acc, _ = evaluate(model, va_images[:, me], va_labels[:, me], dev)
        if me == 0:
            print(f"epoch {epoch}: loss {loss:.4f} val_acc {val_acc:.3f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        history.append((loss, val_acc))
        if args.checkpoint_format:
            path = args.checkpoint_format.format(epoch=epoch + 1)
            bf.checkpoint.save(path, opt, step=epoch + 1)
    return history, opt


if __name__ == "__main__":
    train(parse_args())
