#!/usr/bin/env python3
"""The MoE's capacity and routing selections as a stable descending sort
(``models.moe.top_k``, JAX's tie order) against ``torch.topk`` (no order
among ties), timed in qwen2-moe-a2.7b's full-width bf16 prefill of
tokens (2, 4096) and alone at each shape that prefill selects over;
needs one CUDA card.

    python3 scripts/moe_topk_time.py [--reps 5]

The two selections alternate in one process (sort, topk, topk, sort),
each round a warm prefill and then ``--reps`` timed ones (CUDA events,
the median kept); the selections alone are timed likewise, 20 calls a
round.  Prints the card's name and power limit beside every number.
Imports nothing of JAX.
"""
from __future__ import annotations

import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _topk(x, k: int):
    import torch
    return torch.topk(x, k, dim=-1)


def _ms(torch, fn, reps: int) -> float:
    """The median of ``reps`` timed calls of ``fn``, in ms."""
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main() -> int:
    import argparse

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import build
    from repro_torch.models import moe
    from repro_torch.models.api import build as build_model
    from repro_torch.models.api import compute_params
    from repro_torch.models.params import init_params
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("[fail] no CUDA device", file=sys.stderr)
        return 1
    stamp = cs.card_stamp()
    print(f"[card] {stamp}; torch {torch.__version__}", flush=True)
    build(["flash_attention"])
    dev = torch.device("cuda")
    cfg = get_config("qwen2-moe-a2.7b")
    model = build_model(cfg)
    params = init_params(model.decls,
                         torch.Generator(device=dev).manual_seed(0), dev,
                         dtype_override=torch.bfloat16)
    cparams = compute_params(params, cfg)
    B, S = cs.PREFILL_SHAPE
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device=dev)}
    variants = {"stable sort": moe.top_k, "torch.topk": _topk}
    shapes = []

    def recording(x, k):
        shapes.append((tuple(x.shape), x.dtype, k))
        return variants["stable sort"](x, k)
    moe.top_k = recording
    with torch.no_grad():
        model.prefill(cparams, batch)
    sites = sorted(set(shapes), key=str)
    print(f"[moe-topk] the prefill selects over {len(shapes)} calls, "
          f"shapes {[(s, str(d), k) for s, d, k in sites]}", flush=True)
    prefill = {name: [] for name in variants}
    alone = {(name, site): [] for name in variants for site in sites}
    for name in ("stable sort", "torch.topk", "torch.topk", "stable sort"):
        moe.top_k = variants[name]
        with torch.no_grad():
            model.prefill(cparams, batch)
            prefill[name].append(_ms(
                torch, lambda: model.prefill(cparams, batch), args.reps))
        for site in sites:
            shape, dtype, k = site
            x = torch.rand(shape, generator=gen, device=dev).to(dtype)
            variants[name](x, k)
            alone[(name, site)].append(_ms(
                torch, lambda: variants[name](x, k), 20))
    moe.top_k = variants["stable sort"]
    for name, ms in prefill.items():
        print(f"[moe-topk] qwen2-moe-a2.7b prefill of tokens ({B}, {S}) "
              f"bf16 with {name}: {ms} ms (median of {args.reps}, two "
              f"rounds)  [{stamp}]", flush=True)
    for (name, (shape, dtype, k)), ms in alone.items():
        print(f"[moe-topk] {name} of {shape} {dtype} top {k} alone: {ms} "
              f"ms (median of 20, two rounds)  [{stamp}]", flush=True)
    print(f"[card] {stamp}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
