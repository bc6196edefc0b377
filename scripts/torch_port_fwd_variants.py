#!/usr/bin/env python3
"""The forward kernel beside variants of its own source, on one card.

    python3 scripts/torch_port_fwd_variants.py

Builds ``csrc/flash_fwd.cu`` as committed and as each variant below (the
committed source with some of its design constants set otherwise, built
from a copy in a temporary directory), prints every build's ptxas register,
spill and warning lines, checks each variant's (o, m, l) against the
committed kernel's at B=1 H=16 S=8192 D=128 causal (bit-identical, or within
``chip_smoke``'s limits: o/l ``TOL_FWD``, m ``TOL_M``, l ``TOL_L``
relative), then times K1 of every build in turns (committed, variants,
committed, variants, ...) with CUDA events, three rounds, with the time of
``scaled_dot_product_attention``'s forward in each round as a yardstick.
Needs one CUDA card.

Variants (constants of ``flash_fwd.cu``; the committed source is one of
them, so its row repeats under another name as a check on the spread):
  kv64_s2      64-row K/V tiles (S as m64n64), a 2-deep ring, no overlap
  kv64_s3      64-row K/V tiles, a 3-deep ring
  kv128_s2     128-row K/V tiles (S as m64n128), a 2-deep ring
  kv128_s3     128-row K/V tiles, a 3-deep ring (224 KB at D=128)
  overlap_s2   64-row tiles, P.V of tile j-1 issued with the S of tile j and
               run under the softmax of tile j (a stage is then held for two
               tiles, so no copy runs ahead with 2 stages)
  overlap_s3   the same with a 3-deep ring
  overlap_s4   the same with a 4-deep ring
  kv128_overlap_s3   128-row tiles with overlap, a 3-deep ring
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from bluefog_tpu_torch.parallel import _build  # noqa: E402
from bluefog_tpu_torch.parallel import flash as fl  # noqa: E402
from torch_port_bwd_variants import build_all, sources, use  # noqa: E402

LIB = "flash_fwd"
SETTINGS = {
    "kv64_s2": {"KROWS": "64", "STAGES": "2", "OVERLAP": "false"},
    "kv64_s3": {"KROWS": "64", "STAGES": "3", "OVERLAP": "false"},
    "kv128_s2": {"KROWS": "128", "STAGES": "2", "OVERLAP": "false"},
    "kv128_s3": {"KROWS": "128", "STAGES": "3", "OVERLAP": "false"},
    "overlap_s2": {"KROWS": "64", "STAGES": "2", "OVERLAP": "true"},
    "overlap_s3": {"KROWS": "64", "STAGES": "3", "OVERLAP": "true"},
    "overlap_s4": {"KROWS": "64", "STAGES": "4", "OVERLAP": "true"},
    "kv128_overlap_s3": {"KROWS": "128", "STAGES": "3", "OVERLAP": "true"},
}
ROUNDS = 3


def variants(text: str) -> dict:
    """{name: [(old, new)]} setting each variant's constants in ``text``."""
    out = {"committed": []}
    for name, consts in SETTINGS.items():
        subs = []
        for const, value in consts.items():
            found = re.search(rf"constexpr \w+ {const} = [^;]+;", text)
            if found is None:
                raise RuntimeError(f"{const} not in {LIB}.cu")
            new = re.sub(r"= [^;]+;", f"= {value};", found.group(0))
            if new != found.group(0):
                subs.append((found.group(0), new))
        out[name] = subs
    return out


def compare(got, ref) -> str:
    """'bit-identical', or the errors against the committed outputs; raises
    beyond chip_smoke's limits."""
    if all(torch.equal(a, b) for a, b in zip(got, ref)):
        return "bit-identical"
    (o, m, l), (ro, rm, rl) = got, ref
    errs = {"o/l": float((o / l[..., None] - ro / rl[..., None]).abs().max()),
            "m": float((m - rm).abs().max()),
            "l": float(((l - rl).abs() / rl).max())}
    limits = {"o/l": chip_smoke.TOL_FWD, "m": chip_smoke.TOL_M,
              "l": chip_smoke.TOL_L}
    if not all(errs[n] <= limits[n] for n in errs):
        raise RuntimeError(f"variant outside {limits}: {errs}")
    return "within limits " + " ".join(f"{n}={e:.3e}" for n, e in errs.items())


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="fwd_variants_"))
    try:
        text = (_build._CSRC / f"{LIB}.cu").read_text()
        dirs = sources(tmp, variants(text), LIB)
        build_all(dirs, LIB)

        dev = torch.device("cuda", 0)
        B, S, H, D = 1, chip_smoke.SEQ, 16, 128
        gen = torch.Generator(device=dev).manual_seed(7)
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        ref = None
        for name, d in dirs.items():
            use(d, LIB)
            out = fl.flash_block(q, k, v, 0, 0, causal=True)
            ref = ref or out
            print(f"{name}: {compare(out, ref)}", flush=True)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        for rnd in range(ROUNDS):
            for name, d in dirs.items():
                use(d, LIB)
                t = chip_smoke.cuda_ms(
                    lambda: fl.flash_block(q, k, v, 0, 0, causal=True), 20)
                print(f"round {rnd} {name}: K1 {t:.4f} ms", flush=True)
            t = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 20)
            print(f"round {rnd} sdpa fwd: {t:.4f} ms", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
