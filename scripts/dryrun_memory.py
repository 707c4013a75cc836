#!/usr/bin/env python3
"""The dry-run's peak memory held to the card: one production rank of a
cell, run for real.

  python3 scripts/dryrun_memory.py [--arch ARCH ...] [--shape train_4k]
  python3 scripts/dryrun_memory.py --shape prefill_32k

For each cell (``--arch`` at ``--shape`` on the single-pod (16, 16) mesh;
by default llama3.2-3b and one cell of every other family at the shape:
a train step, or a prefill, whose caches it writes into one buffer
allocated before its layer loop):

1. the prediction: the cell's ``peak_device_bytes`` as the dry-run writes
   it (``launch/dryrun.py``: the sharded step traced on ``meta`` at full
   depth), every cell listed
   with its prediction before any runs; a cell whose prediction does not
   fit the card is listed and not run.  The prediction counts what the
   caching allocator holds over the step and nothing else, so a cell fits
   where it is ``FIT_MARGIN`` under the card's free bytes just before it
   runs (``torch.cuda.mem_get_info``, read after the CUDA context and what
   the process already holds): the margin is for what the prediction
   leaves out (cuBLAS's and the kernels' workspaces, the blocks the
   allocator reserves but does not hand out);
2. rank 0 of a ``fake`` group of 256 ranks on ``cuda:0``: its own shards
   of the parameters, the batch and the AdamW state (train) or the caches
   (decode), zeros, placed by
   ``dryrun.sharded_args`` (the dry-run's own placement); the other 255
   ranks do not exist, and the fake group moves nothing, so every
   collective's output is zero-filled in place (no index read from it can
   fault);
3. one step to warm up (cuBLAS's workspace, the kernels' first loads),
   then one step in a window of its own: ``torch.cuda
   .max_memory_allocated`` over it, less what was allocated at its start,
   plus the arguments' allocator blocks (``launch/footprint.step_peak``),
   held to the prediction within 3% or 64 MiB, whichever is larger
   (``footprint.peak_tolerance``).

Prints the card's name and power limit, each cell's prediction and
reading, and one JSON line of them all; exits non-zero on a miss.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# the dense cell first, then one cell of each other family
CELLS = ("llama3.2-3b", "qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-7b",
         "whisper-medium", "qwen2-vl-2b")
# what a cell's free bytes must hold beyond its predicted peak
FIT_MARGIN = 2 * 2**30


def card_stamp() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def predictions(archs, shape_name: str) -> dict:
    """{arch: the dry-run's peak memory (``peak_memory``) of its cell}."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    mesh, shape = make_production_mesh(), SHAPES_BY_NAME[shape_name]
    out = {}
    with dryrun.CollectiveTracer() as tracer:
        for arch in archs:
            out[arch] = dryrun.peak_memory(get_config(arch), shape, mesh,
                                           tracer)
    return out


class ZeroFill:
    """While entered, every functional collective's output is zeroed in
    place: the fake group writes nothing into it."""

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(t.__name__ == "DTensor" for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                if func.namespace == "_c10d_functional":
                    for o in (out if isinstance(out, (list, tuple))
                              else [out]):
                        if isinstance(o, torch.Tensor):
                            o.zero_()
                return out
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False


def run_rank(arch: str, shape_name: str, dm) -> dict:
    """Rank 0's step of the cell on ``cuda:0`` over ``dm``: the window's
    peak as the trace counts it, and its parts."""
    import torch

    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.distributed.sharding import shard_ctx
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    from repro_torch.launch import dryrun
    from repro_torch.launch.footprint import (held_bytes, step_peak,
                                              window_start)
    from repro_torch.launch.mesh import make_production_mesh
    cfg, mesh = get_config(arch), make_production_mesh()
    shape = SHAPES_BY_NAME[shape_name]
    model, spec, args, place = dryrun.sharded_args(cfg, shape, mesh, dm,
                                                   "cuda")
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    with shard_ctx(cfg, mesh, dm), ZeroFill():
        out = dryrun.run_step(model, cfg, spec, args, place)
        del out
        base = window_start()
        t0 = time.perf_counter()
        out = dryrun.run_step(model, cfg, spec, args, place)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = step_peak(base, args)
        raw = torch.cuda.max_memory_allocated()
        del out
    held = held_bytes(args)
    res = {"arch": arch, "shape": shape_name, "step_peak_bytes": peak,
           "max_memory_allocated": raw, "allocated_at_start": base,
           "argument_blocks": held, "step_s": wall,
           "flash_attention": flash_attention.launches - f0,
           "flash_attention_bwd": flash_attention_bwd.launches - b0}
    del args, model
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs a rank on the card",
              file=sys.stderr)
        return 1
    stamp = card_stamp()
    print(f"[card] {stamp}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    archs = args.arch or list(CELLS)
    t0 = time.perf_counter()
    want = predictions(archs, args.shape)
    free, total = torch.cuda.mem_get_info()
    room = free - FIT_MARGIN
    print(f"[predict] {len(archs)} cells traced on meta in "
          f"{time.perf_counter() - t0:.1f} s of host; the card holds "
          f"{total} B, {free} B of it free; a cell fits under {room} B "
          f"(free less a margin of {FIT_MARGIN} B)", flush=True)
    for arch in archs:
        w = want[arch]
        print(f"[predict] {arch} {args.shape} rank 0 of (16, 16): peak "
              f"{w['peak_bytes']} B ({w['peak_bytes'] / 2**30:.3f} GiB), "
              f"arguments {w['entry_bytes']} B"
              f"{'' if w['peak_bytes'] < room else ': does not fit, not run'}",
              flush=True)

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.footprint import peak_tolerance
    from repro_torch.launch.mesh import device_mesh, make_production_mesh
    mesh = make_production_mesh()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    rows, bad = [], []
    try:
        dm = device_mesh(mesh, "cuda")
        for arch in archs:
            w = want[arch]
            room = torch.cuda.mem_get_info()[0] - FIT_MARGIN
            if w["peak_bytes"] >= room:
                rows.append({"arch": arch, "predicted": w["peak_bytes"],
                             "room": room, "run": False})
                continue
            got = run_rank(arch, args.shape, dm)
            diff = w["peak_bytes"] - got["step_peak_bytes"]
            tol = peak_tolerance(got["step_peak_bytes"])
            print(f"[rank] {arch} {args.shape}: step peak "
                  f"{got['step_peak_bytes']} B ({got['step_peak_bytes'] / 2**30:.3f}"
                  f" GiB; max_memory_allocated {got['max_memory_allocated']}"
                  f" B over the window, {got['allocated_at_start']} B at its "
                  f"start, arguments {got['argument_blocks']} B in blocks) "
                  f"against the prediction {w['peak_bytes']} B: "
                  f"{diff:+d} B ({diff / got['step_peak_bytes']:+.3%}; bound "
                  f"{tol:.0f} B); step {got['step_s']:.3f} s, flash launches "
                  f"{got['flash_attention']} + {got['flash_attention_bwd']} "
                  f"backward  [{stamp}]", flush=True)
            if abs(diff) > tol:
                bad.append(f"{arch}: predicted {w['peak_bytes']} B, the card "
                           f"{got['step_peak_bytes']} B")
            rows.append({**got, "predicted": w["peak_bytes"], "run": True})
    finally:
        dist.destroy_process_group()
    for mod in ("jax", "repro"):
        if mod in sys.modules:
            bad.append(f"{mod} was imported")
    print(json.dumps({"card": stamp, "cells": rows}))
    if bad:
        print(f"FAIL: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
