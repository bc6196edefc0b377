"""Transformer-LM headline benchmark: tokens/s and MFU on one card.

    python -m bluefog_tpu_torch.lm_bench [--seq-len 8192] [--d-model 2048]
        [--num-layers 4] [--num-heads 16] [--batch 1] [--vocab 32768]
        [--steps 20] [--warmup 3] [--remat] [--chunked-ce] [--ce-chunk 1024]

Counterpart of ``scripts/lm_bench.py`` with its flags and defaults: the
flash ``TransformerLM`` (d_ff = 4 d_model, bf16 compute, f32 parameters;
the forward runs the flash forward kernel, the backward the two flash
backward kernels) trained by plain ``torch.optim.Adam`` (lr 1e-3) on one
batch of random tokens. No decentralized optimizer: the JAX script uses
``optax.adam`` alone. The loss is the full-logits cross-entropy, or
``parallel.chunked_ce_loss`` with ``--chunked-ce``; ``--remat`` alone
checkpoints the whole forward, logits included, and with ``--chunked-ce``
the backbone (``remat_backbone``). Timing: ``warmup`` untimed steps, then
``steps`` steps on the host clock in one window closed by one
``torch.cuda.synchronize()``.

FLOPs accounting (PaLM-style model FLOPs, causal), as the JAX script:
  matmul params: 6 * N_matmul * tokens   (fwd + bwd)
  attention:     12 * L * B * S^2 * d_model * 0.5
``mfu`` divides their rate by ``H100_BF16_PEAK``, the H100 SXM's dense bf16
peak (the JAX script divides by the TPU v5e's).

Prints ONE JSON line with the JAX script's keys plus ``device`` (the card's
name; ``mfu`` is null for a run on the CPU).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .models import TransformerLM
from .parallel.flash import flash_attention
from .parallel.lm import chunked_ce_loss
from .runtime.state import resolve_device

H100_BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core peak, FLOP/s

DEFAULTS = dict(seq_len=8192, d_model=2048, num_layers=4, num_heads=16,
                batch=1, vocab=32768, steps=20, warmup=3, ce_chunk=1024)


def matmul_param_count(model: torch.nn.Module) -> int:
    """Parameters that induce matmul FLOPs: every >=2-D weight EXCEPT the
    embedding table (a gather, not a matmul; the lm_head projection is a
    separate weight and is counted)."""
    return sum(p.numel() for name, p in model.named_parameters()
               if p.dim() >= 2 and "embed" not in name.lower())


def model_flops(n_mat: int, batch: int, seq_len: int, num_layers: int,
                d_model: int) -> float:
    """Model FLOPs of one training step (the JAX script's formula)."""
    return (6 * n_mat * batch * seq_len
            + 12 * num_layers * batch * seq_len ** 2 * d_model * 0.5)


def loss_fn(chunked_ce: bool, remat: bool,
            ce_chunk: int = 1024) -> Callable:
    """The benchmark's ``loss(model, (tokens, targets))``."""
    if chunked_ce:
        def chunked(model, batch):
            return chunked_ce_loss(model, *batch, chunk=ce_chunk,
                                   remat_backbone=remat)
        return chunked

    def full(model, batch):
        toks, tgts = batch
        logits = checkpoint(model, toks, use_reentrant=False) if remat \
            else model(toks)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tgts.reshape(-1))
    return full


def make_step(model: torch.nn.Module, loss: Callable,
              lr: float = 1e-3) -> Callable:
    """One training step of ``model`` under plain Adam: ``step(batch)``
    returns the step's loss (detached, on the model's device)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def step(batch):
        opt.zero_grad(set_to_none=True)
        value = loss(model, batch)
        value.backward()
        opt.step()
        return value.detach()
    return step


def run(seq_len: int, d_model: int, num_layers: int, num_heads: int,
        batch: int, vocab: int, steps: int, warmup: int, remat: bool,
        chunked_ce: bool = False, ce_chunk: int = 1024, *,
        device=None) -> dict:
    """Build, warm up and time the step; print and return the result."""
    if steps < 1:
        raise ValueError("--steps must be >= 1")
    dev = resolve_device(device)
    model = TransformerLM(
        vocab_size=vocab, num_layers=num_layers, num_heads=num_heads,
        d_model=d_model, d_ff=4 * d_model, dtype=torch.bfloat16,
        attn_fn=flash_attention, device=dev, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, vocab, (batch, seq_len), generator=gen,
                           device=dev)
    batch_ = (tokens, tokens.roll(-1, dims=1))
    step = make_step(model, loss_fn(chunked_ce, remat, ce_chunk))

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        step(batch_)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        last = step(batch_)
    sync()              # ONE closing sync (the reference's methodology)
    dt = (time.perf_counter() - t0) / steps

    n_mat = matmul_param_count(model)
    tokens_per_step = batch * seq_len
    flops = model_flops(n_mat, batch, seq_len, num_layers, d_model)
    on_card = dev.type == "cuda"
    result = {
        "metric": "lm_tokens_per_s",
        "seq_len": seq_len, "d_model": d_model, "layers": num_layers,
        "batch": batch, "params_m": round(n_mat / 1e6, 1),
        "ms_per_step": round(dt * 1e3, 2),
        "value": round(tokens_per_step / dt),
        "unit": "tokens/s",
        # a share of the H100's peak: none for a run on the CPU
        "mfu": (round(flops / dt / H100_BF16_PEAK, 3) if on_card else None),
        "final_loss": round(float(last), 3),
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }
    print(json.dumps(result), flush=True)
    return result


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq-len", type=int, default=DEFAULTS["seq_len"])
    p.add_argument("--d-model", type=int, default=DEFAULTS["d_model"])
    p.add_argument("--num-layers", type=int, default=DEFAULTS["num_layers"])
    p.add_argument("--num-heads", type=int, default=DEFAULTS["num_heads"])
    p.add_argument("--batch", type=int, default=DEFAULTS["batch"])
    p.add_argument("--vocab", type=int, default=DEFAULTS["vocab"])
    p.add_argument("--steps", type=int, default=DEFAULTS["steps"])
    p.add_argument("--warmup", type=int, default=DEFAULTS["warmup"])
    p.add_argument("--remat", action="store_true",
                   help="checkpoint the whole forward (longer S fits)")
    p.add_argument("--chunked-ce", action="store_true",
                   help="chunked vocab projection + CE (no [S, V] logits)")
    p.add_argument("--ce-chunk", type=int, default=DEFAULTS["ce_chunk"])
    a = p.parse_args()
    run(a.seq_len, a.d_model, a.num_layers, a.num_heads, a.batch, a.vocab,
        a.steps, a.warmup, a.remat, a.chunked_ce, a.ce_chunk)


if __name__ == "__main__":
    main()
