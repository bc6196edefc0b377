"""Least time of the flash kernels K1-K3 at [B, S, H, D], causal, offsets 0.

A frozen copy of ``chip_smoke.py``'s ``kernel_bounds``: the larger of a
kernel's products' FLOPs over the bf16 peak (every product runs in bf16)
and its bytes over the memory rate (each input read once, each output
written once).
"""

from .peaks import H100_BF16_FLOPS, H100_HBM_BYTES


def kernel_bounds(B: int, S: int, H: int, D: int) -> dict:
    """``{kernel: seconds}`` for ``flash_fwd``, ``flash_bwd_dq`` and
    ``flash_bwd_dkv``."""
    pairs = B * H * S * (S + 1) // 2         # causal live (q, k) pairs
    prod = 2.0 * pairs * D                   # FLOP of one [q,k]x[.,D] product
    bf16_in = B * S * H * D * 2
    f32_row = B * S * H * D * 4
    stats = B * S * H * 4
    work = {
        # K1: s, P.V; reads q, k, v, writes o, m, l
        "flash_fwd": (2, 3 * bf16_in + f32_row + 2 * stats),
        # K2: s, dp, dq; reads q, k, v, g, m, l, d, writes dq
        "flash_bwd_dq": (3, 3 * bf16_in + 2 * f32_row + 3 * stats),
        # K3: s, dp, dv, dk; reads the same, writes dk, dv
        "flash_bwd_dkv": (4, 3 * bf16_in + 3 * f32_row + 3 * stats),
    }
    return {name: max(n * prod / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES)
            for name, (n, nbytes) in work.items()}
