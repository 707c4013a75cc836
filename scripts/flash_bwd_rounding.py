#!/usr/bin/env python3
"""Why the bf16 ``flash_attention`` backward feeds P and dS to the tensor
cores as two bf16 halves: a CPU emulation of the kernel's rounding.

  python3 scripts/flash_bwd_rounding.py

For each shape (B, S, H, Hkv, Dh, causal), seeded bf16 q, k, v and dO and
the plain forward's O (rounded to bf16) and log-sum-exp, it forms P, dP, D
and dS in f32 from an f64 score, then the three gradients with P and dS
either rounded once to bf16 or as hi = bf16(x) plus lo = bf16(x - hi),
products and sums in f64, outputs rounded to bf16.  It prints each
gradient's error against the f64 gradient (``flash_attention_bwd_ref`` in
f64) over twice the plain version's own error (its f32 gradient rounded to
bf16): the bound ``chip_smoke.py`` phase 14 and the card tests hold the
kernel to (<= 1).  CPU only; imports nothing of JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SHAPES = [(2, 1500, 4, 4, 64, False), (2, 1000, 8, 2, 128, True),
          (1, 257, 8, 2, 112, True)]


def inputs(B, S, H, Hkv, Dh, causal):
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(s, generator=g).to(torch.bfloat16)
                   for s in ((B, S, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh),
                             (B, S, H, Dh)))
    o, lse = flash_attention_ref(q.float(), k.float(), v.float(), causal,
                                 with_lse=True)
    return q, k, v, o.to(torch.bfloat16), lse, do, causal


def emulate(q, k, v, o, lse, do, causal, split: bool):
    """(dq, dk, dv) with P and dS in bf16 (``split``: as hi + lo)."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qd, kd, vd, od, dod = (t.double().transpose(1, 2) for t in (
        q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2), o, do))
    s = qd @ kd.transpose(-1, -2) * Dh ** -0.5
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse.double()[..., None]).float()
    dp = (dod @ vd.transpose(-1, -2)).float()
    ds = p * (dp - (dod * od).sum(-1).float()[..., None])

    def rounded(x):
        hi = x.to(torch.bfloat16).double()
        return hi + (x.double() - hi).to(torch.bfloat16).double() if split \
            else hi
    dv = rounded(p).transpose(-1, -2) @ dod
    dk = rounded(ds).transpose(-1, -2) @ qd * Dh ** -0.5
    dq = rounded(ds) @ kd * Dh ** -0.5
    dk, dv = (t.reshape(B, Hkv, G, S, Dh).sum(2) for t in (dk, dv))
    return tuple(t.transpose(1, 2).to(torch.bfloat16) for t in (dq, dk, dv))


def main() -> int:
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    for shape in SHAPES:
        args = inputs(*shape)
        q, k, v, o, lse, do, causal = args
        plain = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)),
                                        lse, do.float(), causal)
        exact = flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o)),
                                        lse.double(), do.double(), causal)
        for split in (False, True):
            got = emulate(*args, split)
            ratios = []
            for g, p, e in zip(got, plain, exact):
                own = float((p.to(torch.bfloat16).double() - e).abs().max())
                ratios.append(float((g.double() - e).abs().max()) / (2 * own))
            print(f"{shape} P and dS {'as hi + lo' if split else 'in bf16'}: "
                  f"error against f64 over twice the plain version's own, "
                  f"dq {ratios[0]:.3f}, dk {ratios[1]:.3f}, dv {ratios[2]:.3f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
