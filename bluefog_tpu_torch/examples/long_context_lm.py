"""Long-context LM training with ring-attention sequence parallelism.

The port of ``examples/long_context_lm.py``. The sequence dimension is
sharded across the ranks: each holds S/n tokens, K/V blocks rotate one rank
forward per step (``bluefog_tpu_torch.parallel.cp_loss_fn``), so the
trainable context length scales linearly with the number of ranks.

Run at world 4 on the CPU (one process per rank):

    torchrun --standalone --nproc_per_node 4 \\
        -m bluefog_tpu_torch.examples.long_context_lm --device cpu

``--attention flash`` instead trains the full sequence on every rank
through the CUDA flash kernels (their plain versions on the CPU): the
single-device long-context path for when there is one card.
"""

from __future__ import annotations

import argparse
import time
from functools import partial

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import parallel as bfp
from bluefog_tpu_torch.models import TransformerLM, lm_loss


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--attention", default="ring",
                   choices=["ring", "ulysses", "flash"])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    bf.init(device=args.device)
    try:
        _train(args)
    finally:
        bf.shutdown()


def _train(args) -> None:
    n, me = bf.size(), bf.rank()
    if args.attention != "flash" and args.seq_len % n:
        raise SystemExit(f"--seq-len must be divisible by {n} ranks")
    dev = torch.device(args.device)   # cuda: the card init selected
    attn_fn = None
    if args.attention == "flash":
        attn_fn = partial(bfp.flash_attention, causal=True)
    model = TransformerLM(
        vocab_size=args.vocab, num_layers=args.num_layers,
        num_heads=args.num_heads, d_model=args.d_model,
        d_ff=4 * args.d_model, dtype=torch.bfloat16, attn_fn=attn_fn,
        device=dev, seed=0)

    rng = np.random.RandomState(0)
    # synthetic "copy task"-flavoured data: next token = current + 1 mod V
    start = rng.randint(0, args.vocab, (args.batch_size, 1))
    tokens = torch.as_tensor((start + np.arange(args.seq_len)) % args.vocab,
                             dtype=torch.long, device=dev)
    targets = tokens.roll(-1, dims=1)

    if args.attention == "flash":
        loss_fn, batch = lm_loss, (tokens, targets)
    else:
        loss_fn = bfp.cp_loss_fn(model, kind=args.attention)
        sq = args.seq_len // n
        batch = (tokens[:, me * sq:(me + 1) * sq],
                 targets[:, me * sq:(me + 1) * sq])
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)

    def say(*a) -> None:
        if me == 0:
            print(*a, flush=True)

    if args.attention == "flash":
        # no sequence sharding: one rank owns the full context (the kernel,
        # not the ring, is what makes the length affordable)
        say(f"seq {args.seq_len} full-sequence on one chip, flash attention")
    else:
        say(f"{n} chip(s), seq {args.seq_len} ({args.seq_len // n}/chip), "
            f"{args.attention} attention")
    t0 = time.time()
    for i in range(args.steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        loss = loss.detach()
        if i % 5 == 0 or i == args.steps - 1:
            say(f"step {i}: loss {float(loss):.4f}")
    say(f"{args.steps} steps in {time.time() - t0:.1f}s; "
        f"final loss {float(loss):.4f}")


if __name__ == "__main__":
    main()
