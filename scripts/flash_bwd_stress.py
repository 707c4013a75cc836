#!/usr/bin/env python3
"""The bf16 ``flash_attention`` backward run many times over, on one CUDA
card: every run bit-equal to the first, and the first held to the bound of
``chip_smoke.py`` phase 14 and the card tests.

  python3 scripts/flash_bwd_stress.py

For each shape (B, S, H, Hkv, Dh, causal): tile edges, ragged and single
rows, GQA, full attention, the train step's and llama3.2-3b's prefill, it
makes seeded bf16 inputs and the forward kernel's O and log-sum-exp, runs
``flash_attention_bwd`` 200 times (30 at S = 4096), counts the runs that
differ from the first in any bit, and prints the first run's error against
the f64 gradient over twice the plain version's own bf16 error (<= 1).
Exits non-zero without a card, on a differing run or past the bound.
Imports nothing of JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SHAPES = [(8, 128, 24, 8, 128, True), (2, 1000, 8, 2, 128, True),
          (1, 65, 4, 2, 8, True), (1, 129, 4, 2, 112, False),
          (2, 1500, 4, 4, 64, False), (2, 4096, 24, 8, 128, True),
          (1, 1, 2, 1, 128, True), (2, 37, 4, 2, 8, True)]


def main() -> int:
    from repro_torch.kernels.flash_attention.ops import (_forward,
                                                         flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    bad = 0
    for B, S, H, Hkv, Dh, causal in SHAPES:
        g = torch.Generator().manual_seed(0)
        q, k, v, do = (torch.randn(s, generator=g).to("cuda", torch.bfloat16)
                       for s in ((B, S, H, Dh), (B, S, Hkv, Dh),
                                 (B, S, Hkv, Dh), (B, S, H, Dh)))
        o, lse = _forward(q, k, v, causal, with_lse=True)
        first = flash_attention_bwd(q, k, v, o, lse, do, causal)
        runs = 30 if S >= 4096 else 200
        differ = sum(
            not all(torch.equal(a, b) for a, b in zip(
                first, flash_attention_bwd(q, k, v, o, lse, do, causal)))
            for _ in range(runs))
        plain = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)),
                                        lse, do.float(), causal)
        exact = flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o)),
                                        lse.double(), do.double(), causal)
        top = max(float(w.abs().max()) for w in plain)
        ratio = max(
            float((a.double() - e).abs().max())
            / (2 * float((p.to(torch.bfloat16).double() - e).abs().max())
               + 1e-6 * top)
            for a, p, e in zip(first, plain, exact))
        finite = all(bool(torch.isfinite(t).all()) for t in first)
        bad += differ > 0 or ratio > 1 or not finite
        print(f"{(B, S, H, Hkv, Dh, causal)}: {runs} runs, {differ} differ "
              f"from the first; error against f64 {ratio:.3f} of twice the "
              f"plain version's own; finite {finite}  "
              f"[{torch.cuda.get_device_name(0)}]", flush=True)
    print("all runs bit-equal and within the bound" if not bad
          else f"{bad} shapes failed")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
