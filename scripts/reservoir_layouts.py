#!/usr/bin/env python3
"""Every layout of ``reservoir_topm`` timed on the sampler's own buckets, on
one CUDA card.

  python3 scripts/reservoir_layouts.py

Makes the first full-width graphsage-products training batch as
``chip_smoke.py``'s phase 4 does (seed 0) and buckets its hops 2 and 3 as
phase 8 does (``hop_buckets``, the same seeded uniforms).  For each bucket,
and for the hub row unpadded, it runs the launcher's layout
(``kernels/reservoir/ops.py:layout``) and every other layout the kernel
takes there: the narrow kernel and a one-warp chunk at N <= 32, and
chunks of W·32·K lanes (W warps of K keys a lane, W, K in 1, 2, 4, 8;
split over as many blocks as the row needs) above.  Each output is held
``torch.equal`` to the launcher's, and the launcher's to the plain
version; each layout is timed with ``chip_smoke.py``'s harness (median of
50 calls, L2 flushed before each).  Prints a line per bucket and layout,
the fastest layout of each bucket, and each hop's sum for the launcher's
layouts and for the fastest.  Exits non-zero without a CUDA card or on a
mismatch.  Imports nothing of JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def candidates(N: int):
    """The layouts the kernel takes for rows of N lanes."""
    from repro_torch.kernels.reservoir.ops import Layout, chunked
    out = []
    if N <= 32:
        out += [Layout(seg=1 << (N - 1).bit_length()), Layout(0, 1, 1, 1, 1)]
        return out
    for W in (1, 2, 4, 8):
        for K in (1, 2, 4, 8):
            lanes = 32 * W * K
            if lanes >= 2 * N:
                continue
            out.append(chunked(N, K, W, N))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[fail] no CUDA device: this script times kernels on a GPU",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.a3gnn import A3GNNTrainer
    from repro_torch.core.sampling import NeighborSampler, seed_loader
    from repro_torch.graph.synthetic import dataset_like
    from repro_torch.kernels.reservoir.ops import layout, reservoir_topm
    from repro_torch.kernels.reservoir.ref import reservoir_topm_ref

    cfg = get_config("graphsage-products").replace(
        sampling_device="device", fused_gather_agg=True)
    g = dataset_like(cfg, seed=0)
    tr = A3GNNTrainer(g, cfg, seed=0, device="cuda")
    sampler = NeighborSampler(tr.graph, cfg.fanout, weight_fn=tr.weight_fn,
                              seed=0)
    seeds = next(iter(seed_loader(tr.graph, cfg.batch_size, 0)))
    mb = sampler.sample(seeds)
    train = {"graph": tr.graph, "mb": mb, "weight_fn": tr.weight_fn,
             "fanout": cfg.fanout}
    dev = torch.device("cuda")
    hops = cs.reservoir_hops(torch, train, np.random.default_rng(0))
    indptr, indices = tr.graph.adj()
    hub = int(np.argmax(np.diff(indptr)))
    nb = indices[indptr[hub]:indptr[hub + 1]]
    hub_case = ("hub", 5, *(torch.from_numpy(x).to(dev) for x in (
        tr.weight_fn(nb)[None].astype(np.float32),
        np.random.default_rng(1).random((1, len(nb)), dtype=np.float32),
        np.ones((1, len(nb)), bool))))
    hops["hub"] = {"m": 5, "cases": [hub_case]}

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    stamp = cs.card_stamp()
    print(f"[card] {stamp}", flush=True)
    for hop, h in hops.items():
        auto_sum = best_sum = 0.0
        for label, m, w, u, mask in h["cases"]:
            R, N = w.shape
            auto = layout(N)
            want = reservoir_topm(w, u, mask, m)
            ref = reservoir_topm_ref(w, u, mask, m)
            if not (torch.equal(want[0], ref[0]) and torch.equal(
                    want[1].view(torch.int32), ref[1].view(torch.int32))):
                print(f"[fail] {label}: the launcher's layout {auto} differs "
                      f"from the plain version", file=sys.stderr)
                return 1
            times = {}
            for plan in dict.fromkeys([auto, *candidates(N)]):
                got = reservoir_topm(w, u, mask, m, plan=plan)
                if not (torch.equal(got[0], want[0]) and torch.equal(
                        got[1].view(torch.int32), want[1].view(torch.int32))):
                    print(f"[fail] {label}: layout {plan} differs from the "
                          f"launcher's", file=sys.stderr)
                    return 1
                times[plan] = cs.time_ms(
                    torch, lambda p=plan: reservoir_topm(w, u, mask, m,
                                                         plan=p), flush)
                blocks = (-(-R // (8 * 32 // plan.seg)) if plan.seg
                          else R * plan.P)
                print(f"[layout] {label} ({R}, {N}) m={m}: {tuple(plan)} "
                      f"{blocks} blocks{' (launcher)' if plan == auto else ''}"
                      f": {times[plan]} ms  [{stamp}]", flush=True)
            best = min(times, key=times.get)
            auto_sum += times[auto]
            best_sum += times[best]
            print(f"[best] {label} ({R}, {N}) m={m}: {tuple(best)} "
                  f"{times[best]} ms; launcher {tuple(auto)} {times[auto]} ms"
                  f"  [{stamp}]", flush=True)
        print(f"[sum] {hop}: launcher {auto_sum} ms, fastest layouts "
              f"{best_sum} ms  [{stamp}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
