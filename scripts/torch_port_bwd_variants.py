#!/usr/bin/env python3
"""The backward kernels beside variants of their own source, on one card.

    python3 scripts/torch_port_bwd_variants.py

Builds ``csrc/flash_bwd.cu`` as committed and as each variant below (a text
substitution of the committed source, built from a copy in a temporary
directory), prints every build's ptxas register, spill, warning and
performance-loss lines, checks that each variant's dq, dk and dv equal the
committed kernels' bit for bit at B=1 H=16 S=8192 D=128 causal, then times
K2 and K3 of every build in turns (committed, variants, committed,
variants, ...) with CUDA events. Needs one CUDA card.

Variants:
  no_overlap   S and dP both finish before P is computed (no exp/dP overlap)
  stages3      a 3-deep copy ring instead of 2
  regs_40_232  setmaxnreg split 40 (producer) / 232 (consumers), not 24/240
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from bluefog_tpu_torch.parallel import _build  # noqa: E402
from bluefog_tpu_torch.parallel import flash as fl  # noqa: E402

VARIANTS = {
    "committed": [],
    "no_overlap": [("wgmma_wait<1>();", "wgmma_wait<0>();")],
    "stages3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "regs_40_232": [("reg_dealloc<24>", "reg_dealloc<40>"),
                    ("reg_alloc<240>", "reg_alloc<232>")],
}
ROUNDS = 3


def sources(tmp: Path, variants: dict, lib: str = "flash_bwd") -> dict:
    """A csrc copy per variant, with its (old, new) substitutions applied to
    ``<lib>.cu``."""
    out = {}
    for name, subs in variants.items():
        d = tmp / name
        shutil.copytree(_build._CSRC, d)
        text = (d / f"{lib}.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        (d / f"{lib}.cu").write_text(text)
        out[name] = d
    return out


def use(csrc: Path, lib: str = "flash_bwd") -> None:
    _build._CSRC = csrc
    _build._libs.pop(lib, None)


def build_all(dirs: dict, lib: str = "flash_bwd") -> None:
    """Builds every variant's library, all nvcc processes at once, and prints
    each build's ``chip_smoke.ptxas_lines`` (empty for a library that was
    already built)."""
    jobs, started = {}, set()
    for name, d in dirs.items():
        use(d, lib)
        out = _build._lib_path(lib)   # a variant equal to another builds once
        jobs[name] = (out, None) if out in started else _build._start(lib)
        started.add(out)
    for name, d in dirs.items():
        use(d, lib)
        log = _build._finish(lib, *jobs[name])
        print(f"build {name}: {chip_smoke.ptxas_lines(log)}", flush=True)


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="bwd_variants_"))
    try:
        dirs = sources(tmp, VARIANTS)
        build_all(dirs)

        dev = torch.device("cuda", 0)
        B, S, H, D = 1, chip_smoke.SEQ, 16, 128
        gen = torch.Generator(device=dev).manual_seed(7)
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        g = torch.randn((B, S, H, D), generator=gen, device=dev)
        o, m, l = fl.flash_block(q, k, v, 0, 0, causal=True)
        d_term = (g * (o / l[..., None]).to(torch.bfloat16).float()).sum(-1)
        args = (q, k, v, g, d_term, m, l, 0, 0)
        ref = None
        for name, d in dirs.items():
            use(d)
            out = fl.flash_block_bwd(*args, causal=True)
            if ref is None:
                ref = out
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            print(f"{name}: bit-identical to committed: {same}", flush=True)
            if not same:
                raise RuntimeError(f"variant {name} changed the outputs")
        for rnd in range(ROUNDS):
            for name, d in dirs.items():
                use(d)
                t_dq = chip_smoke.cuda_ms(
                    lambda: fl.flash_bwd_dq(*args, causal=True), 20)
                t_dkv = chip_smoke.cuda_ms(
                    lambda: fl.flash_bwd_dkv(*args, causal=True), 20)
                print(f"round {rnd} {name}: K2 {t_dq:.4f} ms K3 "
                      f"{t_dkv:.4f} ms", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
