#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Three phases; any failure exits non-zero:

1. build — compile every CUDA source of the port (one ``nvcc`` each, all
   started together) and print the seconds it took;
2. kernels — call each kernel's wrapper at the shapes the main path gives
   it, hold the result bit-exact against its plain PyTorch version, then
   time kernel, plain version and the library yardstick with CUDA events
   (median of 50 launches, L2 flushed before each) beside the bytes bound;
3. the slice at full width — ``repro_torch.launch.serve`` for
   graphsage-products with the device feature plane: 4 warm-up train
   steps, 64 node queries at batch 4, a streamed feature update and a
   re-query.  Launch counts are zeroed just before and read just after,
   and the outputs are checked (finite logits, every query done, the
   forward agreeing with the same forward on the CPU on a small batch).

Every line with a time, rate or size carries the card's name and power
limit.  The next-to-last line is a JSON list of the ported kernels and the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ARCH = "graphsage-products"
SERVE_ARGS = ["--gnn", "--arch", ARCH, "--sampling-device", "device",
              "--train-steps", "4", "--queries", "64", "--batch", "4"]
TIMED_LAUNCHES = 50
SPIN_CYCLES = 1_000_000          # ~0.5 ms of device clock ahead of each call
# data-sheet HBM rates (NVIDIA), matched against the card's name in order
HBM_BYTES_PER_S = [("H200", 4.8e12), ("H100 NVL", 3.9e12),
                   ("H100 PCIe", 2.0e12), ("H100", 3.35e12)]


def fail(msg: str):
    print(f"[fail] {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_stamp() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    fail(f"no data-sheet memory rate for {name!r}")


def time_ms(torch, fn, flush) -> float:
    """Median device time of one call, over TIMED_LAUNCHES calls after a
    warm-up, with the L2 cache flushed before each.  A spin kernel ahead of
    the start event keeps the card busy while the host enqueues the call,
    so host-side launch cost does not land between the two events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def host_us(torch, fn) -> float:
    """Host time to issue one call (enqueue only), mean of TIMED_LAUNCHES."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_LAUNCHES):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / TIMED_LAUNCHES * 1e6


def phase_build(stamp: str):
    from repro_torch.kernels.build import build, sources
    t0 = time.perf_counter()
    built = build(sources())
    print(f"[build] {sources()} (compiled {built}) in "
          f"{time.perf_counter() - t0:.2f} s  [{stamp}]", flush=True)


def phase_kernels(torch, stamp: str) -> dict:
    """cache_gather against its plain version; returns the JSON entry."""
    from repro_torch.kernels.gather.ops import cache_gather
    from repro_torch.kernels.gather.ref import cache_gather_ref
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def inputs(n, C, F, dtype):
        cache = torch.randn((C, F), generator=g).to(dev, dtype)
        slots = torch.randint(0, C, (n,), generator=g, dtype=torch.int32)
        slots[torch.rand(n, generator=g) < 0.25] = -1     # ~25% misses
        return slots.to(dev), cache

    # (label, n, C, F, dtype, timed): the serving step's input level, one
    # 4,096-row chunk, a whole training batch, and the F=602 contract
    cases = [("serve_step", 4224, 98000, 100, torch.float32, True),
             ("chunk", 4096, 98000, 100, torch.float32, True),
             ("train_batch", 75489, 98000, 100, torch.float32, True),
             ("f602_f32", 37, 1000, 602, torch.float32, False),
             ("f602_bf16", 37, 1000, 602, torch.bfloat16, False),
             ("f37_bf16", 37, 1000, 37, torch.bfloat16, False)]  # 2-byte words
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > L2
    rate = hbm_rate(torch.cuda.get_device_name(0))
    max_err, entry = 0.0, None
    for label, n, C, F, dtype, timed in cases:
        slots, cache = inputs(n, C, F, dtype)
        out, miss = cache_gather(slots, cache)
        ref_out, ref_miss = cache_gather_ref(slots, cache)
        torch.cuda.synchronize()
        exact = torch.equal(out, ref_out) and torch.equal(miss, ref_miss)
        err = float((out.float() - ref_out.float()).abs().max())
        max_err = max(max_err, err)
        print(f"[kernel] cache_gather {label} n={n} C={C} F={F} {dtype}: "
              f"bit-exact={exact} max_abs_err={err}", flush=True)
        if not exact:
            fail(f"cache_gather disagrees with its plain version at {label}")
        if not timed:
            continue
        clamped = slots.clamp(min=0).long()
        hits = int((slots >= 0).sum())
        isz = cache.element_size()
        nbytes = (hits + n) * F * isz + 8 * n     # rows read + written, ids
        t = {"ms": time_ms(torch, lambda: cache_gather(slots, cache), flush),
             "plain_ms": time_ms(torch, lambda: cache_gather_ref(slots, cache),
                                 flush),
             "library_ms": time_ms(
                 torch, lambda: torch.index_select(cache, 0, clamped), flush),
             "bound_ms": nbytes / rate * 1e3}
        call_us = host_us(torch, lambda: cache_gather(slots, cache))
        print(f"[time] cache_gather {label} n={n} F={F}: kernel "
              f"{t['ms']} ms, plain {t['plain_ms']} ms, index_select "
              f"{t['library_ms']} ms, bytes bound {t['bound_ms']} ms "
              f"({nbytes} B at {rate / 1e12} TB/s); wrapper host cost "
              f"{call_us:.1f} us/call  [{stamp}]", flush=True)
        if label == "chunk":
            entry = t
    return {"name": "cache_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gather.cu",
            "replaces": "src/repro/kernels/gather/kernel.py:39",
            "max_abs_err": max_err, "bound_by": "bytes", **entry}


def phase_slice(torch, stamp: str) -> dict:
    """The serving slice at full width; returns the launch counts."""
    import numpy as np

    from repro_torch.core.sampling import NeighborSampler
    from repro_torch.graph.batch import generate_batch, inference_arrays
    from repro_torch.kernels.gather.ops import cache_gather
    from repro_torch.launch.serve import build_parser, run_gnn_serve
    from repro_torch.models.gnn import gnn_forward
    from repro_torch.models.params import leaves

    args = build_parser().parse_args(SERVE_ARGS)
    buf = io.StringIO()
    cache_gather.launches = 0
    with contextlib.redirect_stdout(buf):
        rep = run_gnn_serve(args)
    torch.cuda.synchronize()
    launches = {"cache_gather": cache_gather.launches}
    for line in buf.getvalue().splitlines():
        print(f"{line}  [{stamp}]", flush=True)

    tr, eng = rep["trainer"], rep["engine"]
    if not all(p.is_cuda for p in leaves(tr.params)):
        fail("trainer parameters are not on cuda")
    warm = rep["warmup"]
    if len(warm.losses) != 4 or not all(map(math.isfinite, warm.losses)):
        fail(f"warm-up losses {warm.losses}")
    served = rep["served"]
    if len(served) != 64 or any(r.status != "done" for r in served):
        fail(f"{sum(r.status == 'done' for r in served)}/64 queries done")
    ncls = tr.cfg.num_classes
    if not all(r.logits.shape == (ncls,) and
               bool(torch.isfinite(torch.from_numpy(r.logits)).all())
               for r in served):
        fail("served logits are not finite (num_classes,) vectors")
    rq = rep["requery"]
    if rq.rid != 64 or rq.status != "done":
        fail("the streamed update's re-query did not run")
    if rep["launches_warmup"] <= 0 or rep["launches_serve"] <= 0:
        fail(f"cache_gather launches: warm-up {rep['launches_warmup']}, "
             f"serving {rep['launches_serve']}")
    s = rep["stats"]
    print(f"[slice] {ARCH} full width: losses {warm.losses}; "
          f"{len(served)} queries done at {s['queries_per_s']:.1f} q/s, "
          f"p50 {s['p50_ms']:.2f} ms p99 {s['p99_ms']:.2f} ms; "
          f"cache_gather launches warm-up {rep['launches_warmup']} "
          f"serving {rep['launches_serve']} total "
          f"{launches['cache_gather']}  [{stamp}]", flush=True)
    n = max(warm.steps, 1)
    print(f"[breakdown] warm-up train step: sample {warm.t_sample / n * 1e3:.1f} "
          f"ms, batch (plane fetch) {warm.t_batch / n * 1e3:.1f} ms, train "
          f"{warm.t_train / n * 1e3:.1f} ms  [{stamp}]", flush=True)

    # outputs against a reference: the device plane's rows equal the host
    # store, and the forward on the card agrees with the CPU forward
    g = tr.graph
    nodes = np.array([r.node for r in served[:4]], dtype=np.int64)
    mb = NeighborSampler(g, tr.cfg.fanout, seed=7).sample(nodes)
    mb = generate_batch(mb, eng.plane, g)
    if not (mb.features == g.features[mb.input_ids]).all():
        fail("device-plane rows differ from the host feature store")
    arrays = inference_arrays(mb)
    cpu_params = {"layers": [{k: v.cpu() for k, v in layer.items()}
                             for layer in tr.params["layers"]]}
    with torch.inference_mode():
        on_card = eng._fwd(tr.params, arrays["features"],
                           arrays["neigh_idxs"])
        on_cpu = gnn_forward(
            cpu_params, torch.from_numpy(arrays["features"]),
            [torch.from_numpy(i) for i in arrays["neigh_idxs"]],
            tr.cfg).numpy()
    diff = float(abs(on_card - on_cpu).max())
    print(f"[check] nodes {nodes.tolist()}: plane rows bit-exact; forward "
          f"cuda vs cpu max_abs_diff={diff}", flush=True)
    if not diff <= 1e-4:
        fail(f"forward on the card differs from the CPU by {diff}")
    serving_breakdown(torch, eng, served, stamp)
    return launches


def serving_breakdown(torch, eng, served, stamp: str):
    """Host-clock split of a serving step (4 seeds) into its stages, the
    median over 16 steps: each stage ends in a copy to the host, so the
    card's work is inside the stage that issued it."""
    import numpy as np

    from repro_torch.graph.batch import generate_batch, inference_arrays
    stages = {"sample": [], "plane_fetch": [], "pad": [], "forward": []}
    for i in range(16):
        seeds = np.array([r.node for r in served[4 * i:4 * i + 4]],
                         dtype=np.int64)
        t0 = time.perf_counter()
        mb = eng.sampler.sample(seeds)
        t1 = time.perf_counter()
        mb = generate_batch(mb, eng.plane, eng.graph)
        t2 = time.perf_counter()
        arrays = inference_arrays(mb, level_caps=eng._level_caps)
        t3 = time.perf_counter()
        eng._fwd(eng.params, arrays["features"], arrays["neigh_idxs"])
        t4 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[k].append(dt * 1e3)
    parts = ", ".join(f"{k} {float(np.median(v)):.3f} ms"
                      for k, v in stages.items())
    print(f"[breakdown] serving step (4 seeds, median of 16): {parts}  "
          f"[{stamp}]", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} is missing: run from a checkout")
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (sets full-f32 matmuls on the card)

    stamp = card_stamp()
    print(f"[card] {stamp}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    phase_build(stamp)
    entry = phase_kernels(torch, stamp)
    launches = phase_slice(torch, stamp)
    entry["launches"] = launches["cache_gather"]
    for mod in ("jax", "repro"):
        if mod in sys.modules:
            fail(f"{mod} was imported")
    print(f"[card] {stamp}")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
