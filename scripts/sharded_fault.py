#!/usr/bin/env python3
"""Plants faults in the sharded LM step and checks that ``chip_smoke.py``'s
phase 19 (b) fails on each; needs one CUDA card.

    python3 scripts/sharded_fault.py [--arch llama3.2-3b zamba2-7b ...] \
        [--seed N]

Each fault runs phase 19 (b) of each run in ``SHARDED_RUNS`` (or those of
``--arch``) as the script runs it (llama3.2-3b, zamba2-7b and
whisper-medium at full width, 2 ``gloo-host`` ranks on a (1, 2) mesh,
held to the unsharded step), with each rank's code changed in its own
process:

* ``allreduce_left_out``: every gradient that is a partial sum over the
  mesh (the norm scales') taken as the rank's own part, not reduced;
* ``dk_off_10pct``: the ``flash_attention`` backward's dK on each rank's
  head shard 10% too small.

``--seed`` draws each run's weights and batch from seed N in place of
the run's own; the sound run (no fault) then runs first and must pass.
Prints the readings of each, and exits non-zero if phase 19 passes with a
fault planted or fails without one.  Imports nothing of JAX.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def allreduce_left_out(rank, device, spec):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.launch.group import sharded_lm_rank
    from repro_torch.train import trainer

    def placed_like(grads, p_l):
        out = []
        for g, p in zip(grads, p_l):
            if is_dtensor(g) and any(q.is_partial() for q in g.placements):
                g = DTensor.from_local(
                    g.to_local(), g.device_mesh,
                    [Replicate() if q.is_partial() else q
                     for q in g.placements], run_check=False)
            out.append(g.redistribute(p.device_mesh, p.placements)
                       if is_dtensor(g) else g)
        return out
    trainer.placed_like = placed_like
    return sharded_lm_rank(rank, device, spec)


def dk_off_10pct(rank, device, spec):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.group import sharded_lm_rank
    backward = ops.FlashAttention.backward

    def off(ctx, do):
        dq, dk, dv, none = backward(ctx, do)
        return dq, dk * 0.9, dv, none
    ops.FlashAttention.backward = staticmethod(off)
    return sharded_lm_rank(rank, device, spec)


FAULTS = {"allreduce_left_out": allreduce_left_out,
          "dk_off_10pct": dk_off_10pct}


def main() -> int:
    import argparse
    import torch
    if not torch.cuda.is_available():
        print("[fail] no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.build import build
    stamp = cs.card_stamp()
    print(f"[card] {stamp}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    build(["flash_attention", "flash_attention_bwd"])
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    runs = {spec["arch"]: spec for spec in cs.SHARDED_RUNS}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=list(runs), choices=runs)
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args()
    wrong = []
    for arch in args.arch:
        if args.seed is not None:
            runs[arch] = {**runs[arch], "seed": args.seed}
            print(f"[fault] {arch} seed {args.seed}: sound", flush=True)
            try:
                cs.phase_sharded(torch, stamp, specs=[runs[arch]],
                                 cells=False)
            except SystemExit:
                wrong.append(f"{arch} sound run failed")
        for name, fn in FAULTS.items():
            print(f"[fault] {arch} {name}: planted", flush=True)
            try:
                cs.phase_sharded(torch, stamp, specs=[runs[arch]],
                                 cells=False, rank=fn)
            except SystemExit:
                print(f"[fault] {arch} {name}: phase 19 failed, as it must"
                      f"  [{stamp}]", flush=True)
                continue
            wrong.append(f"{arch} {name}")
            print(f"[fault] {arch} {name}: phase 19 PASSED with the fault "
                  f"planted", flush=True)
    if wrong:
        print(f"[fail] phase 19 misread {wrong}", file=sys.stderr)
        return 1
    print(f"[card] {stamp}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
