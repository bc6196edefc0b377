"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

H100_BF16_FLOPS = 989e12   # tensor cores, bf16, FLOP/s
H100_HBM_BYTES = 3.35e12   # device memory, bytes/s
