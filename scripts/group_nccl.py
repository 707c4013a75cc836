#!/usr/bin/env python3
"""The multi-partition run over ``nccl``, a card a rank, held to the same
run on the host-simulated mesh; needs two CUDA cards (step 7 four).

  python3 scripts/group_nccl.py [--steps 1 2 3 4 5 6 7] [--arch ARCH ...]

1. The launcher as a user runs it: ``python -m repro_torch.launch.train``
   with ``chip_smoke.py``'s phase-9 arguments (graphsage-products at full
   width, ``--partitions 2 --halo-budget 4096 --fused-gather-agg --steps
   8``), which spawns rank r on ``cuda:r`` over ``nccl``; it must exit 0
   and print rank 0's lines.
2. The reference: the same run in a child process that sees one card
   (``CUDA_VISIBLE_DEVICES=0``), so both partitions run in it on the
   host-simulated mesh; its summary (``launch.train
   .multipartition_summary``, the halo rows, the committed checkpoint and
   the median of 3 warm global steps) comes back through a pickle file.
3. The group run: ``gnn_rank`` on 2 ``nccl`` ranks, ``cuda:0`` and
   ``cuda:1``, held to the reference as ``chip_smoke.py``'s phase 16 (a)
   holds its gloo ranks (each partition's losses, params, ``opt_state``,
   accuracy, statistics, halo rows, the checkpoint and its manifest:
   bit-equal, the launches summed over the ranks equal), with each rank's
   median of 3 warm global steps beside the reference's.
4. Every group collective over the 2 ``nccl`` ranks (``collectives_rank``:
   the gradient mean, ``compressed_psum_int8``, the cross-pod transform,
   ``flash_decode_attention`` at qwen3-4b's decode shape), bit-equal to
   the host-simulated forms on ``cuda:0``.
5. ``chip_smoke.py``'s phase 17 (a) and (b) over 2 ``nccl`` ranks, a card
   each (``launch.train.autotune_rank``: the halo-budget swaps, the edges
   and the rebalance, the streamed rows and their refresh, the scripted
   auto-tuner with its ``partitions`` restarts 2 -> 1 -> 2), held as phase
   17 holds its gloo ranks (``chip_smoke.hold_live``) to the same sequence
   host-simulated in a child that sees one card, each episode's fleet
   throughput beside the reference's.
6. ``chip_smoke.py``'s phase 18 over 2 ``nccl`` ranks, a card each: the
   GPipe pipeline of llama3.2-3b's 8 seeded bf16 layers in 2 stages of 4
   (``launch.group.pipeline_rank``, stage r on ``cuda:r``), forward and
   backward, held by SHA-256 digests to the host-simulated pipeline run
   first in this process on ``cuda:0``, the launches summed over the
   ranks (64 forward and 64 backward ``flash_attention``), each rank's
   wall beside the reference's.

7. ``chip_smoke.py``'s phase 19 (b) over 4 ``nccl`` ranks, a card each,
   as a (2, 2) ``(data, model)`` mesh, for each ``--arch`` of its
   ``SHARDED_RUNS`` (llama3.2-3b by default; zamba2-7b and
   whisper-medium): the arch at full width and the run's depth (llama3.2-3b
   4 seeded bf16 layers), the train step sharded as DTensors
   (``launch.group.sharded_lm_rank``: batch rows and, on the model axis,
   heads, vocab and MLP split in two; FSDP gathers and reduce-scatters
   over the data axis), held as phase 19 holds its gloo ranks to the
   unsharded step on ``cuda:0`` (loss, every gradient against an f32
   witness, the bytes each rank's collectives moved equal to the
   dry-run's trace of the same step, its last step's own peak within
   ``footprint.peak_tolerance`` of the trace's, the flash launches) with
   each rank's step wall and peak allocation.  Needs four cards.

``--steps`` runs the steps named (all by default; step 3 runs step 2, its
reference).  Prints the cards' name and power limit; exits non-zero on a mismatch or
with fewer than two cards.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT_S = 900


def _reference(out: str) -> int:
    """Step 2, in the child that sees one card."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.launch.train import (build_parser, halo_rows,
                                          multipartition_summary, run_gnn)
    from repro_torch.kernels import launch_counts
    ckpt = Path(tempfile.mkdtemp(prefix="group_nccl_ref_"))
    args = build_parser().parse_args(cs.MULTIPART_ARGS +
                                     ["--ckpt-dir", str(ckpt)])
    rep = run_gnn(args)
    torch.cuda.synchronize()
    ref = multipartition_summary(rep)
    ref["launches"] = launch_counts()
    step = rep["restored_step"]
    with np.load(ckpt / f"step_{step:09d}" / "shard_0.npz") as z:
        ref["ckpt"] = {k: z[k] for k in z.files}
    ref["manifest"] = json.loads(
        (ckpt / f"step_{step:09d}" / "MANIFEST.json").read_text())
    ref["halo_rows"] = halo_rows(rep["trainer"])
    shutil.rmtree(ckpt, ignore_errors=True)
    walls = []
    for _ in range(cs.GROUP_TIMED_STEPS):
        t0 = time.perf_counter()
        rep["trainer"].global_step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ref["step_ms"] = float(np.median(walls)) * 1e3
    for t in (rep["trainer"], rep["restored"]):
        for slot in t.slots:
            slot.pipe.shutdown()
    Path(out).write_bytes(pickle.dumps(ref))
    return 0


def _live_reference(out: str) -> int:
    """Step 5's reference, in the child that sees one card."""
    import chip_smoke as cs
    from repro_torch.launch.train import autotune_rank, build_parser
    args = build_parser().parse_args(cs.LIVE_ARGS)
    ref = autotune_rank(0, "cuda:0", args, ops=cs.LIVE_SEQUENCE[:-1])
    Path(out).write_bytes(pickle.dumps(ref))
    return 0


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    if len(sys.argv) == 3 and sys.argv[1] == "--reference":
        return _reference(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--live-reference":
        return _live_reference(sys.argv[2])
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, nargs="+",
                    default=[1, 2, 3, 4, 5, 6, 7], choices=range(1, 8))
    ap.add_argument("--arch", nargs="+", default=["llama3.2-3b"],
                    help="step 7's runs, by arch (chip_smoke.SHARDED_RUNS)")
    args = ap.parse_args()
    steps = set(args.steps)
    if 3 in steps:
        steps.add(2)
    import torch
    if torch.cuda.device_count() < 2:
        print(f"[fail] {torch.cuda.device_count()} CUDA cards: the two-rank "
              f"nccl run needs two", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.build import build
    stamp = cs.card_stamp()
    print(f"[card] {stamp}; {torch.cuda.device_count()} cards; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    if 7 in steps and torch.cuda.device_count() < 4:
        print(f"[fail] {torch.cuda.device_count()} CUDA cards: step 7's "
              f"(2, 2) mesh needs four", file=sys.stderr)
        return 1
    build(["gather", "segment_agg", "fused_gather_agg"] +
          (["flash_attention", "flash_attention_bwd"]
           if steps & {6, 7} else []))
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    for step, run in ((1, _launcher), (2, _group_run), (4, _collectives),
                      (5, _live), (6, _pipeline), (7, _sharded)):
        if step in steps:
            run(torch, cs, stamp, env, steps, args)
    print(f"[card] {stamp}")
    return 0


def _launcher(torch, cs, stamp, env, steps, args):
    """1. the launcher."""
    ckpt = tempfile.mkdtemp(prefix="group_nccl_cli_")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *cs.MULTIPART_ARGS,
         "--ckpt-dir", ckpt], env=env, text=True, capture_output=True,
        timeout=LAUNCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"{line}  [launcher, nccl; {stamp}]", flush=True)
    print(f"[group] launcher: exit {proc.returncode} in {wall:.1f} s host; "
          f"checkpoints {sorted(p.name for p in Path(ckpt).glob('step_*'))}"
          f"  [{stamp}]", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    if proc.returncode != 0 or "[restore] fresh trainer restored from " \
            "step 8" not in proc.stdout:
        print(proc.stderr[-4000:], file=sys.stderr)
        cs.fail("the launcher over nccl failed")


def _group_run(torch, cs, stamp, env, steps, args):
    """2. the reference on one card and, when asked, 3. the group run held
    to it."""
    from repro_torch.launch.group import spawn_partitions
    from repro_torch.launch.train import build_parser, gnn_rank
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "ref.pkl"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, __file__, "--reference", str(out)],
            env={**env, "CUDA_VISIBLE_DEVICES": "0"}, text=True,
            capture_output=True, timeout=LAUNCH_TIMEOUT_S)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            cs.fail("the host-simulated reference failed")
        ref = pickle.loads(out.read_bytes())
    print(f"[group] reference: host-simulated, both partitions on one card, "
          f"{time.perf_counter() - t0:.1f} s host; median warm global step "
          f"{ref['step_ms']:.1f} ms  [{stamp}]", flush=True)
    if 3 not in steps:
        return

    # 3. the group run, held to the reference
    ckpt = Path(tempfile.mkdtemp(prefix="group_nccl_run_"))
    args = build_parser().parse_args(cs.MULTIPART_ARGS +
                                     ["--ckpt-dir", str(ckpt)])
    t0 = time.perf_counter()
    ranks = spawn_partitions(gnn_rank, 2, "nccl", ["cuda:0", "cuda:1"],
                             args=(args, None, cs.GROUP_TIMED_STEPS, True),
                             timeout=cs.GROUP_JOIN_S)
    wall = time.perf_counter() - t0
    import numpy as np
    step = ranks[0]["restored_step"]
    with np.load(ckpt / f"step_{step:09d}" / "shard_0.npz") as z:
        disk = {k: z[k] for k in z.files}
    manifest = json.loads(
        (ckpt / f"step_{step:09d}" / "MANIFEST.json").read_text())
    shutil.rmtree(ckpt, ignore_errors=True)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    bad = [d for r, got in enumerate(ranks)
           for d in cs._hold_group_rank(r, got, ref)]
    diff = cs._first_difference(disk, ref["ckpt"], f"checkpoint {step}")
    bad += [diff] if diff else []
    manifest.pop("time")
    if manifest != {k: v for k, v in ref["manifest"].items() if k != "time"}:
        bad.append("the checkpoint's MANIFEST.json differs")
    if launches != ref["launches"]:
        bad.append(f"launches {launches}, the reference's "
                   f"{ref['launches']}")
    meds = [float(np.median(r["step_seconds"])) * 1e3 for r in ranks]
    print(f"[group] 2 nccl ranks, cuda:0 and cuda:1: launches summed "
          f"{launches}; against the reference (losses, params, opt_state, "
          f"the restored trainer, accuracy {ranks[0]['acc']}, hit rates, "
          f"halo rows, the step-{step} checkpoint and manifest): "
          f"{'bit-equal' if not bad else bad}; median of "
          f"{cs.GROUP_TIMED_STEPS} warm global steps rank 0 {meds[0]:.1f} "
          f"ms, rank 1 {meds[1]:.1f} ms (reference {ref['step_ms']:.1f} "
          f"ms); spawn to results {wall:.1f} s host  [{stamp}]", flush=True)
    if bad:
        cs.fail(f"the nccl group run differs: {bad[0]}")


def _collectives(torch, cs, stamp, env, steps, args):
    """4. the collectives over 2 nccl ranks."""
    from repro_torch.launch.group import collectives_rank, spawn_partitions
    inputs = cs._group_shim_inputs(torch, 2, 18)
    got = spawn_partitions(collectives_rank, 2, "nccl",
                           ["cuda:0", "cuda:1"], args=(inputs,),
                           timeout=cs.GROUP_JOIN_S)
    bad = cs._hold_group_shims(torch, got, inputs, 2)
    print(f"[group] collectives over 2 nccl ranks (a card each) against "
          f"their host-simulated forms on cuda:0: "
          f"{'bit-equal' if not bad else bad}", flush=True)
    if bad:
        cs.fail(f"nccl collectives: {bad[0]}")


def _live(torch, cs, stamp, env, steps, args):
    """5. phase 17 (a) and (b) over 2 nccl ranks."""
    from repro_torch.launch.group import spawn_partitions
    from repro_torch.launch.train import autotune_rank, build_parser
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "live.pkl"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, __file__, "--live-reference", str(out)],
            env={**env, "CUDA_VISIBLE_DEVICES": "0"}, text=True,
            capture_output=True, timeout=LAUNCH_TIMEOUT_S)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            cs.fail("the live reference failed")
        ref = pickle.loads(out.read_bytes())
    t_ref = time.perf_counter() - t0
    args = build_parser().parse_args(cs.LIVE_ARGS)
    t0 = time.perf_counter()
    ranks = spawn_partitions(autotune_rank, 2, "nccl", ["cuda:0", "cuda:1"],
                             args=(args, None, None, cs.LIVE_SEQUENCE[:-1]),
                             timeout=cs.GROUP_JOIN_S)
    t_group = time.perf_counter() - t0
    _, bad = cs.hold_live(ranks, ref, stamp, "2 nccl ranks, a card each")
    print(f"[live] nccl: reference {t_ref:.1f} s host (its child's start "
          f"included), spawn to both results {t_group:.1f} s  [{stamp}]",
          flush=True)
    if bad:
        cs.fail(f"the nccl live run differs: {bad[0]}")


def _pipeline(torch, cs, stamp, env, steps, args):
    """6. phase 18 over 2 nccl ranks, a card each."""
    cs.phase_pipeline(torch, stamp, "nccl", ("cuda:0", "cuda:1"))


def _sharded(torch, cs, stamp, env, steps, args):
    """7. phase 19 (b) over 4 nccl ranks as a (2, 2) mesh, each --arch."""
    runs = {spec["arch"]: spec for spec in cs.SHARDED_RUNS}
    unknown = set(args.arch) - set(runs)
    if unknown:
        raise SystemExit(f"no phase-19 run of {sorted(unknown)}: "
                         f"{sorted(runs)}")
    cs.phase_sharded(torch, stamp, tuple(f"cuda:{r}" for r in range(4)),
                     "nccl", [{**runs[a], "mesh": (2, 2)} for a in args.arch],
                     cells=False)


if __name__ == "__main__":
    raise SystemExit(main())
