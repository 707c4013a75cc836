#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases; any failure exits non-zero:

1. build — compile every CUDA source of the port (one ``nvcc`` each, all
   started together) and print the seconds it took;
2. cache_gather — call the wrapper at the shapes the serving path gives
   it, hold the result bit-exact against its plain PyTorch version, then
   time kernel, plain version and the library yardstick with CUDA events
   (median of 50 launches, L2 flushed before each) beside the bytes bound;
3. the serving slice at full width — ``repro_torch.launch.serve`` for
   graphsage-products with the device feature plane: 4 warm-up train
   steps, 64 node queries at batch 4, a streamed feature update and a
   re-query.  Launch counts are zeroed just before and read just after,
   and the outputs are checked (finite logits, every query done, the
   forward agreeing with the same forward on the CPU on a small batch);
4. the fused training slice at full width — ``repro_torch.launch.train
   --arch graphsage-products --sampling-device device --fused-gather-agg
   --steps 8`` through ``run_gnn``, launch counts zeroed just before and
   read just after; then one fused step each for gcn, gat and gin on the
   same graph (the sum, weighted-forward and weighted-backward paths).
   The first step's loss and gradients on the card are held against the
   same step on the CPU, from the same parameters and batch;
5. gather_aggregate and neighbor_agg (forward and backward) at the shapes
   of that first batch, plus GAT's weighted shapes and odd widths: held
   against their plain versions and timed as in phase 2, with
   ``F.embedding_bag`` as the yardstick of ``neighbor_agg``.

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
TRAIN_ARGS = ["--arch", ARCH, "--sampling-device", "device",
              "--fused-gather-agg", "--steps", "8"]
TIMED_LAUNCHES = 50
SPIN_CYCLES = 1_000_000          # ~0.5 ms of device clock ahead of each call
# data-sheet HBM rates (NVIDIA), matched against the card's name in order
HBM_BYTES_PER_S = [("H200", 4.8e12), ("H100 NVL", 3.9e12),
                   ("H100 PCIe", 2.0e12), ("H100", 3.35e12)]
F32_FLOP_PER_S = 67e12        # H100 SXM f32 outside the tensor cores


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


def _zero_counts():
    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.kernels.gather.ops import cache_gather
    from repro_torch.kernels.segment_agg.ops import (neighbor_agg,
                                                     neighbor_agg_backward)
    fns = {"cache_gather": cache_gather, "gather_aggregate": gather_aggregate,
           "neighbor_agg": neighbor_agg,
           "neighbor_agg_backward": neighbor_agg_backward}
    for fn in fns.values():
        fn.launches = 0
    return lambda: {k: fn.launches for k, fn in fns.items()}


def _close(got, want) -> float:
    """Largest |got - want| / (|want| + max|want|): a relative error that
    holds entries near zero to the tensor's largest."""
    want = want.float()
    scale = want.abs() + want.abs().max()
    return float(((got.float() - want).abs() / scale.clamp(min=1e-30)).max())


def phase_train(torch, stamp: str) -> dict:
    """The fused training slice at full width; returns the launch counts of
    the main path and the first batch's inputs for the kernel phase."""
    import numpy as np

    from repro_torch.core.a3gnn import A3GNNTrainer
    from repro_torch.core.feature_plane import DeviceFeaturePlane
    from repro_torch.core.sampling import NeighborSampler, seed_loader
    from repro_torch.graph.batch import (batch_device_arrays,
                                         compute_level_caps)
    from repro_torch.launch.train import build_parser, run_gnn
    from repro_torch.models.gnn import gnn_loss_allfused
    from repro_torch.models.params import init_params, leaves

    args = build_parser().parse_args(TRAIN_ARGS)
    buf = io.StringIO()
    counts = _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rep = run_gnn(args)
    torch.cuda.synchronize()
    launches = counts()
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"{line}  [{stamp}]", flush=True)
    tr, res = rep["trainer"], rep["result"]
    st, steps = res.stats, res.stats.steps
    if steps != 8 or not all(map(math.isfinite, st.losses)):
        fail(f"training: {steps} steps, losses {st.losses}")
    if not all(p.is_cuda for p in leaves(tr.params)):
        fail("trainer parameters are not on cuda")
    want = {"cache_gather": 0, "gather_aggregate": steps,
            "neighbor_agg": 2 * steps, "neighbor_agg_backward": 2 * steps}
    print(f"[train] {ARCH} fused, full width: {steps} steps, losses "
          f"{st.losses}; {res.throughput_steps_s} steps/s wall clock; "
          f"launches {launches} (expected {want}); run_gnn incl. evaluate "
          f"{wall:.2f} s  [{stamp}]", flush=True)
    if launches != want:
        fail(f"training launches {launches}, expected {want}")
    n = max(steps, 1)
    print(f"[stages] fused train step, mean of {steps} (the first incl. "
          f"one-time set-up): sample {st.t_sample / n * 1e3:.3f} ms, batch "
          f"{st.t_batch / n * 1e3:.3f} ms, train {st.t_train / n * 1e3:.3f} "
          f"ms  [{stamp}]", flush=True)

    # steady state: 8 more steps on the warm trainer (outside the counted
    # run), with the trainer's own split of each fused train stage
    for part in tr.fused_parts.values():
        part.clear()
    pipe = tr.make_pipeline()
    try:
        warm = pipe.run(max_steps=8)
    finally:
        pipe.shutdown()
    n = max(warm.steps, 1)
    print(f"[stages] fused train step, steady state, mean of {warm.steps}: "
          f"sample {warm.t_sample / n * 1e3:.3f} ms, batch "
          f"{warm.t_batch / n * 1e3:.3f} ms, train "
          f"{warm.t_train / n * 1e3:.3f} ms; "
          f"{warm.throughput_steps_per_s()} steps/s  [{stamp}]", flush=True)
    if any(len(v) != warm.steps for v in tr.fused_parts.values()):
        fail(f"fused train stage split has {tr.fused_parts} for "
             f"{warm.steps} steps")
    split = ", ".join(f"{k} {float(np.median(v)) * 1e3:.3f} ms"
                      for k, v in tr.fused_parts.items())
    print(f"[breakdown] fused train stage (A3GNNTrainer.fused_parts, median "
          f"of the {warm.steps} steady steps): {split}  [{stamp}]", flush=True)
    device_breakdown(torch, tr, warm.t_wall / n, stamp)

    # the other model families, one fused step each on the same graph
    for model in ("gcn", "gat", "gin"):
        mt = A3GNNTrainer(tr.full_graph, tr.cfg.replace(model=model),
                          seed=args.seed, device="cuda")
        pipe = mt.make_pipeline()
        counts = _zero_counts()
        try:
            one = pipe.run(max_steps=1)
        finally:
            pipe.shutdown()
        torch.cuda.synchronize()
        got = counts()
        layers = mt.cfg.num_layers
        want = {"cache_gather": 0,
                "gather_aggregate": 0 if model == "gat" else 1,
                "neighbor_agg": layers if model == "gat" else layers - 1}
        want["neighbor_agg_backward"] = want["neighbor_agg"]
        print(f"[train] {model} fused, one step: loss {one.losses}, "
              f"launches {got}  [{stamp}]", flush=True)
        if got != want or not all(map(math.isfinite, one.losses)):
            fail(f"{model}: launches {got} (expected {want}), "
                 f"losses {one.losses}")

    # the first step on the card against the same step on the CPU: the same
    # initial parameters (re-drawn from the seed) and the same first batch
    cfg, g = tr.cfg, tr.graph
    sampler = NeighborSampler(g, cfg.fanout, weight_fn=tr.weight_fn,
                              seed=args.seed)
    seeds = next(iter(seed_loader(g, cfg.batch_size, args.seed)))
    mb = sampler.sample(seeds)
    caps = compute_level_caps(len(seeds), cfg.fanout, g.num_nodes)
    arrays = batch_device_arrays(mb, level_caps=caps)
    plane = DeviceFeaturePlane(g, tr.cache, device="cuda")
    enc, aux, table = plane.fused_inputs(mb.input_ids, arrays["pads"][0])
    batch = {"enc": enc, "aux": aux, "table": table,
             "neigh_idxs": [torch.from_numpy(i).cuda()
                            for i in arrays["neigh_idxs"]],
             "labels": torch.from_numpy(arrays["labels"]).cuda()}
    runs = []                                  # (loss, grads): card, CPU
    for dev in ("cuda", "cpu"):
        params = init_params(tr.decls, torch.Generator().manual_seed(
            args.seed), dev)
        flat = [p.requires_grad_(True) for p in leaves(params)]
        loss, _ = gnn_loss_allfused(
            params, enc.to(dev), aux.to(dev), table.to(dev),
            [i.to(dev) for i in batch["neigh_idxs"]],
            batch["labels"].to(dev), cfg)
        grads = torch.autograd.grad(loss, flat)
        runs.append((float(loss.detach()), [x.cpu() for x in grads]))
    (card_loss, card_grads), (cpu_loss, cpu_grads) = runs
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    step1_rel = abs(st.losses[0] - cpu_loss) / abs(cpu_loss)
    grad_rel = max(_close(a, b) for a, b in zip(card_grads, cpu_grads))
    print(f"[check] first step, {len(mb.input_ids)} input ids, level caps "
          f"{caps}: loss cuda {card_loss} vs cpu {cpu_loss} (rel "
          f"{loss_rel:.2e}; the run's first loss {st.losses[0]}, rel "
          f"{step1_rel:.2e}); gradients rel {grad_rel:.2e} (tolerance 1e-4)",
          flush=True)
    if not (loss_rel <= 1e-4 and step1_rel <= 1e-4 and grad_rel <= 1e-4):
        fail("the first step on the card differs from the CPU beyond 1e-4")
    batch["input_ids"] = len(mb.input_ids)
    batch["real_rows"] = [len(b.dst_ids) for b in mb.blocks]
    return {"launches": launches, "batch": batch}


def device_breakdown(torch, tr, step_s: float, stamp: str):
    """Device time by kernel over 4 warm fused steps (``torch.profiler``,
    device activity only), and the busy share of an un-profiled steady
    step of ``step_s`` seconds (the profiler slows the host, so its own
    window's wall time is not the step's)."""
    from torch.profiler import ProfilerActivity, profile
    pipe = tr.make_pipeline()
    try:
        pipe.run(max_steps=1)                          # warm the path
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pipe.run(max_steps=4)
            torch.cuda.synchronize()
    finally:
        pipe.shutdown()
    # device-side events only (kernels, copies, memsets)
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)),
             e.count) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    if not rows:
        fail("the profiler recorded no device time over 4 fused steps")
    busy_ms = sum(r[1] for r in rows) / 4e3
    top = "; ".join(f"{k[:60]} {t / 4e3:.3f} ms/step ({c // 4}/step)"
                    for k, t, c in rows[:10])
    print(f"[profile] 4 fused steps: device busy {busy_ms:.3f} ms/step "
          f"(kernels and copies summed), {100 * busy_ms / (step_s * 1e3):.2f}"
          f"% of the {step_s * 1e3:.1f} ms steady step; top: {top}  "
          f"[{stamp}]", flush=True)


def _bag_inputs(torch, idx, h):
    """``F.embedding_bag`` form of a padded fanout: −1 → an appended zero
    row at index Ns, which ``padding_idx`` leaves out of the reduction."""
    ns = h.shape[0]
    bag = torch.where(idx < 0, torch.full_like(idx, ns), idx).long()
    return bag, torch.cat([h, torch.zeros_like(h[:1])])


def phase_agg(torch, stamp: str, batch: dict, launches: dict) -> list:
    """gather_aggregate and neighbor_agg at the first batch's shapes, held
    against their plain versions and timed; returns the JSON entries."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.kernels.fused_gather_agg.ref import gather_aggregate_ref
    from repro_torch.kernels.segment_agg.ops import (neighbor_agg,
                                                     neighbor_agg_backward)
    from repro_torch.kernels.segment_agg.ref import (neighbor_agg_bwd_ref,
                                                     neighbor_agg_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rate = hbm_rate(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    enc, aux, table = batch["enc"], batch["aux"], batch["table"]
    idxs = batch["neigh_idxs"]

    def bound(nbytes, flops):
        t_b, t_f = nbytes / rate * 1e3, flops / F32_FLOP_PER_S * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    # -- gather_aggregate: layer 0 (mean: graphsage/gcn; sum: gin) ----------
    idx0 = idxs[0]
    nd, fan = idx0.shape
    f = table.shape[1]
    ga_err, ga = 0.0, None
    for mode in ("mean", "sum"):
        h, a = gather_aggregate(enc, idx0, table, aux, mode=mode)
        h_r, a_r = gather_aggregate_ref(enc, idx0, table, aux, mode=mode)
        torch.cuda.synchronize()
        exact = torch.equal(h, h_r)
        err = float((a - a_r).abs().max())
        ok = bool(torch.allclose(a, a_r, atol=1e-5, rtol=1e-5))
        ga_err = max(ga_err, err)
        print(f"[kernel] gather_aggregate {mode} enc ({enc.shape[0]},) idx "
              f"{tuple(idx0.shape)} table {tuple(table.shape)} aux "
              f"{tuple(aux.shape)}: h_dst bit-exact={exact}, agg "
              f"max_abs_err={err} (tolerance 1e-5)", flush=True)
        if not (exact and ok):
            fail(f"gather_aggregate {mode} disagrees with its plain version")
    # bytes the call needs: the distinct rows it resolves, the enc entries
    # it reads, the indices, and the two outputs
    valid = idx0 >= 0
    refs = torch.cat([torch.arange(nd, device=dev), idx0[valid].long()])
    pos = torch.unique(refs)
    rows = int(torch.unique(enc[pos]).numel())
    nbytes = rows * f * 4 + pos.numel() * 4 + nd * fan * 4 + 2 * nd * f * 4
    b_ms, b_by = bound(nbytes, int(valid.sum()) * f)
    t = {"ms": time_ms(torch, lambda: gather_aggregate(enc, idx0, table, aux),
                       flush),
         "plain_ms": time_ms(torch, lambda: gather_aggregate_ref(
             enc, idx0, table, aux), flush)}
    print(f"[time] gather_aggregate mean idx {tuple(idx0.shape)} F={f}: "
          f"kernel {t['ms']} ms, plain {t['plain_ms']} ms, no library call, "
          f"{b_by} bound {b_ms} ms ({nbytes} B: {rows} distinct rows) "
          f"[{stamp}]", flush=True)
    ga = {"name": "gather_aggregate", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/fused_gather_agg.cu",
          "replaces": "src/repro/kernels/fused_gather_agg/kernel.py:63",
          "launches": launches["gather_aggregate"], "max_abs_err": ga_err,
          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, **t}

    # -- neighbor_agg, forward and backward ---------------------------------
    # (label, idx, Ns, D, mode, timed): the graphsage hops at their level
    # caps, GAT's weighted layer 0 and last hop (D=47), and an odd width
    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    cases = [("hop1", idxs[1], idxs[0].shape[0], 256, "mean", True),
             ("hop2", idxs[2], idxs[1].shape[0], 256, "mean", True),
             ("gin_hop1", idxs[1], idxs[0].shape[0], 256, "sum", False),
             ("gat_layer0", idx0, enc.shape[0], 256, "weighted", True),
             ("gat_last", idxs[2], idxs[1].shape[0], 47, "weighted", False)]
    odd = torch.randint(-1, 20, (9, 4), generator=g, device=dev,
                        dtype=torch.int32)
    cases += [("odd_602_" + m, odd, 20, 602, m, False)
              for m in ("mean", "sum", "weighted")]
    fwd_err, bwd_err, entry = 0.0, 0.0, None
    for label, idx, ns, d, mode, timed in cases:
        h, dout = rnd(ns, d), rnd(idx.shape[0], d)
        w = (torch.rand(idx.shape, generator=g, device=dev)
             if mode == "weighted" else None)
        m = "sum" if w is not None else mode
        out = neighbor_agg(idx, h, m, w)
        dh, dw = neighbor_agg_backward(idx, dout, h, m, w)
        ref = neighbor_agg_ref(idx, h, m, w)
        dh_r, dw_r = neighbor_agg_bwd_ref(idx, dout, h, m, w)
        torch.cuda.synchronize()
        err_f = float((out - ref).abs().max())
        ok_f = bool(torch.allclose(out, ref, atol=1e-5, rtol=1e-5))
        rel_b = _close(dh, dh_r)
        if w is not None:
            rel_b = max(rel_b, _close(dw, dw_r))
        err_b = float((dh - dh_r).abs().max())
        fwd_err, bwd_err = max(fwd_err, err_f), max(bwd_err, err_b)
        print(f"[kernel] neighbor_agg {label} {mode} idx {tuple(idx.shape)} "
              f"h ({ns}, {d}): forward max_abs_err={err_f} (tolerance 1e-5); "
              f"backward max_abs_err={err_b}, rel {rel_b:.2e} (tolerance "
              f"rel 1e-5: atomics)", flush=True)
        if not (ok_f and rel_b <= 1e-5):
            fail(f"neighbor_agg {label} disagrees with its plain version")
        if not timed:
            continue
        nd, fan = idx.shape
        valid = idx >= 0
        nv = int(valid.sum())
        rows = int(torch.unique(idx[valid]).numel())
        wbytes = nd * fan * 4 if w is not None else 0
        fb = rows * d * 4 + nd * d * 4 + nd * fan * 4 + wbytes
        bb = (nd * d * 4 + nd * fan * 4 + ns * d * 4
              + (wbytes + rows * d * 4 + nd * fan * 4 if w is not None else 0))
        fwd_b = bound(fb, nv * d * (2 if w is not None else 1))
        bwd_b = bound(bb, nv * d * (4 if w is not None else 1))
        bag, hp = _bag_inputs(torch, idx, h)
        lib = lambda: F.embedding_bag(bag, hp, mode=m,  # noqa: E731
                                      per_sample_weights=w, padding_idx=ns)
        lib_err = float((lib() - ref).abs().max())
        hp_g = hp.detach().requires_grad_(True)
        lib_out = F.embedding_bag(bag, hp_g, mode=m, per_sample_weights=w,
                                  padding_idx=ns)
        tf = {"ms": time_ms(torch, lambda: neighbor_agg(idx, h, m, w), flush),
              "plain_ms": time_ms(torch, lambda: neighbor_agg_ref(
                  idx, h, m, w), flush),
              "library_ms": time_ms(torch, lib, flush),
              "bound_ms": fwd_b[0], "bound_by": fwd_b[1]}
        tb = {"ms": time_ms(torch, lambda: neighbor_agg_backward(
                  idx, dout, h, m, w), flush),
              "plain_ms": time_ms(torch, lambda: neighbor_agg_bwd_ref(
                  idx, dout, h, m, w), flush),
              "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                  lib_out, [hp_g], dout, retain_graph=True), flush),
              "bound_ms": bwd_b[0], "bound_by": bwd_b[1]}
        print(f"[time] neighbor_agg {label} {mode} idx ({nd}, {fan}) h "
              f"({ns}, {d}), {nv} valid entries, {rows} distinct rows: "
              f"forward kernel {tf['ms']} ms, plain {tf['plain_ms']} ms, "
              f"embedding_bag {tf['library_ms']} ms (max diff {lib_err}), "
              f"{fwd_b[1]} bound {fwd_b[0]} ms ({fb} B); backward kernel "
              f"{tb['ms']} ms, plain {tb['plain_ms']} ms, embedding_bag "
              f"autograd {tb['library_ms']} ms, {bwd_b[1]} bound "
              f"{bwd_b[0]} ms ({bb} B)  [{stamp}]", flush=True)
        if label == "hop1":
            entry = {**tf, **{f"backward_{k}": v for k, v in tb.items()}}
    na = {"name": "neighbor_agg", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/segment_agg.cu",
          "replaces": "src/repro/kernels/segment_agg/kernel.py:56",
          "launches": launches["neighbor_agg"],
          "backward_launches": launches["neighbor_agg_backward"],
          "max_abs_err": fwd_err, "backward_max_abs_err": bwd_err, **entry}
    return [ga, na]


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
    train = phase_train(torch, stamp)
    entries = [entry] + phase_agg(torch, stamp, train["batch"],
                                  train["launches"])
    for mod in ("jax", "repro"):
        if mod in sys.modules:
            fail(f"{mod} was imported")
    print(f"[card] {stamp}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
