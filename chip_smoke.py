#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py [--parent-source PATH]

Phases; any failure exits non-zero:

1. build — compile every CUDA source of the port (one ``nvcc`` each, all
   started together) and print the seconds it took; then, for each
   ``flash_attention`` kernel, ``ptxas``'s registers and spills and the
   dynamic shared memory its launch grants, and the count of ``HGMMA``
   instructions in each kernel's SASS (``cuobjdump -sass`` of the built
   library); ``ptxas``'s registers and spills of every ``neighbor_agg`` and
   ``cache_gather`` kernel, and the atomics in the SASS of the
   ``neighbor_agg`` backward's kernels.  Fails if the bf16 kernel at Dh=128
   has no ``HGMMA``, if a bf16 kernel spills, or if the backward adds a
   float atomically; a machine with no ``cuobjdump`` gets a line saying so;
2. cache_gather — call the wrapper at the shapes the serving path gives
   it (its 4,096- and 128-row chunks among them), hold the result bit-exact
   against its plain PyTorch version, then time kernel, plain version and
   the library yardstick with CUDA events (median of 50 launches, L2
   flushed before each) beside the bytes bound, and the same harness's
   floor (a one-float ``zero_``);
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
   same step on the CPU, from the same parameters and batch, and two card
   steps from that state are compared bit for bit (reported, not failed);
5. gather_aggregate and neighbor_agg (forward and backward) at the shapes
   of that first batch, plus GAT's weighted shapes and odd widths: held
   against their plain versions (the backward's ``dh`` bit-equal to the
   plain version on the CPU, and two launches bit-equal), each hop's
   segment lengths printed, and timed as in phase 2, with
   ``F.embedding_bag`` as the yardstick of ``neighbor_agg`` and the
   parent commit's backward kernel (``git show HEAD~1``, or
   ``--parent-source``) built and timed beside it in turns;
6. flash_attention at the LM slice's shapes (the qwen3-4b prefill, bf16;
   the edges of its 128-row tiles, S = 127, 129 and 4097; Dh=64 at
   S=1000; odd lengths, f32 and non-causal): held against its plain
   version (bf16 by an output-scaled bound that must also refuse two
   faulty outputs, a skipped KV tile and a 3% normaliser error), and the
   qwen3-4b and llama3.2-3b prefills timed as in phase 2 with
   ``F.scaled_dot_product_attention`` as the yardstick (the port never
   calls it), each with its TFLOP/s and share of the bound;
7. the LM serving slice at full width — qwen3-4b with seeded weights on the
   card: ``Model.prefill`` of ``tokens (2, 4096)`` (36 flash_attention
   launches, counted), then ``run_lm_serve``'s engine on 16 requests at
   batch 8, greedy (no flash_attention launch: decode is plain torch),
   each with the counts zeroed just before and read just after; the device
   time of a prefill and a decode step by kernel; then at f32 on a
   64-token prompt, the prefill through the kernel against the prefill
   through the plain version, and the engine's first token against the
   prefill's argmax;
8. reservoir_topm at the sampler's shapes — every padded-width bucket of
   hops 2 and 3 of phase 4's first batch, formed as
   ``NeighborSampler._sample_one_hop`` forms them (γ-bias weights, seeded
   float32 uniforms, ``mask = col < size``), one launch each, the counts
   zeroed before each hop and read after it; held
   bit-exact (idx, and keys bit for bit) against its plain version with
   the hub row and odd shapes; inclusion frequencies of 2^20 rows against
   the exact probabilities (5 standard errors); each bucket timed as in
   phase 2 with ``torch.topk`` over precomputed keys as the yardstick of
   the selection alone and the bytes bound over valid lanes (w and u read
   where the mask is set; the padded-lane figure printed beside it), and
   each hop's sum beside the host numpy time of
   its ``_sample_one_hop``.  Phases 3, 4 and 7 launch it 0 times: no path
   of the port, as none of the JAX package, selects on the card.

Every line with a time, rate or size carries the card's name and power
limit.  The next-to-last line is a JSON list of the ported kernels and the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import re
import shutil
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
PROFILE_CALLS = 20               # calls in a profiled window of a small kernel
PROFILE_TRIES = 3                # windows before an empty profile fails
SPIN_CYCLES = 1_000_000          # ~0.5 ms of device clock ahead of each call
# data-sheet HBM rates (NVIDIA), matched against the card's name in order
HBM_BYTES_PER_S = [("H200", 4.8e12), ("H100 NVL", 3.9e12),
                   ("H100 PCIe", 2.0e12), ("H100", 3.35e12)]
F32_FLOP_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12      # H100 SXM bf16 dense tensor cores
LM_ARCH = "qwen3-4b"
LM_SERVE_ARGS = ["--arch", LM_ARCH, "--requests", "16", "--batch", "8",
                 "--max-len", "512", "--prompt-len", "128", "--max-new", "32"]
PREFILL_SHAPE = (2, 4096)
# flash_attention against its plain version: f32 to |diff| <= 2e-5; bf16 by
# ``bf16_excess`` (kernels/flash_attention/ref.py): per element rtol 1e-2
# plus 2^-8 (P |v|), the bound of rounding P to bf16, and per row 1e-2 of
# the row's norm
FLASH_F32_ATOL = 2e-5
LOGITS_REL_TOL = 1e-4      # f32 prefill, kernel vs plain attention


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
    from repro_torch.kernels.build import BUILD_DIR, build, sources
    t0 = time.perf_counter()
    built = build(sources())
    print(f"[build] {sources()} (compiled {built}) in "
          f"{time.perf_counter() - t0:.2f} s  [{stamp}]", flush=True)
    flash_report()
    gnn_report("segment_agg")
    gnn_report("gather")
    floats = float_atomics(BUILD_DIR / "libsegment_agg.so", "bwd_")
    if floats is None:
        print("[build] no cuobjdump on this machine (toolkit or triton): "
              "the float-atomic check of the neighbor_agg backward was not "
              "made", flush=True)
    elif floats:
        fail(f"the neighbor_agg backward adds floats atomically: {floats}")


def _short_name(mangled: str) -> str:
    """``bwd_short_kernel<4,2>`` / ``cache_gather_kernel<uint4,4>`` for the
    mangled name of a GNN kernel instance."""
    m = re.search(r"\d+((?:bwd|agg|cache)_\w+?_kernel)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end():].split("EEv")[0] + "E"
    word = re.match(r"I(t|j|5uint4)", rest)
    args = ([{"t": "u16", "j": "u32", "5uint4": "uint4"}[word.group(1)]]
            if word else [])
    args += re.findall(r"Li(\d+)E", rest) if rest.startswith("I") else []
    return f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)


def ptxas_report(lib: str, rename) -> dict:
    """ptxas's ``Used`` and spill lines of each kernel in the build log of
    ``csrc/<lib>.cu``, by ``rename(mangled name)``, and its C7512 warnings
    (wgmma serialised)."""
    from repro_torch.kernels.build import build_log
    log = build_log(lib)
    ptxas, name = {}, None
    for line in (log.read_text() if log.exists() else "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = rename(m.group(1))
            ptxas.setdefault(name, {})
        elif "C7512" in line:      # wgmma serialised: names its function
            m = re.search(r"function '(\S+)'", line)
            ptxas.setdefault(rename(m.group(1) if m else ""), {})[
                "warning"] = line.split(":", 1)[1].strip()
        elif name and "spill stores" in line:
            ptxas[name]["spills"] = line.strip()
        elif name and "Used" in line and "registers" in line:
            ptxas[name]["used"] = line.split(":", 1)[1].strip()
    if not ptxas:
        print(f"[build] no ptxas report in {log} (the library was not "
              f"rebuilt in this run)", flush=True)
    return ptxas


def gnn_report(lib: str):
    """ptxas's registers and spills of each kernel of ``csrc/<lib>.cu``."""
    for name, info in sorted(ptxas_report(lib, _short_name).items()):
        print(f"[build] {lib}: {name}: ptxas {info.get('used', 'not reported')}"
              f"; {info.get('spills', 'spills not reported')}", flush=True)


def sass_lines(lib: Path):
    """(function name, line) over ``cuobjdump -sass`` of a built library;
    None when no cuobjdump is found."""
    tool = _cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, name = [], ""
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
        else:
            out.append((name, line))
    return out


# global (REDG, ATOMG), shared (ATOMS) and generic (RED, ATOM) atomics;
# float ones carry a .F16/.BF16/.F32/.F64 type (REDG.E.ADD.F32.FTZ.RN...)
FLOAT_ATOMIC = re.compile(r"\b(?:RED|REDG|ATOM|ATOMG|ATOMS)\.[\w.]*?\.B?F(?:16|32|64)")
ANY_ATOMIC = re.compile(r"\b(?:RED|REDG|ATOM|ATOMG|ATOMS)\.")


def float_atomics(lib: Path, prefix: str):
    """The float atomic instructions (``REDG.E.ADD.F32`` ...) in the SASS of
    the kernels of ``lib`` whose short name starts with ``prefix``, by
    kernel, and a line with every kernel's atomic counts; None when no
    cuobjdump is found."""
    lines = sass_lines(lib)
    if lines is None:
        return None
    floats, counts = {}, {}
    for mangled, line in lines:
        name = _short_name(mangled)
        if not name.startswith(prefix):
            continue
        n_any, n_float = counts.get(name, (0, 0))
        hit = FLOAT_ATOMIC.search(line)
        counts[name] = (n_any + bool(ANY_ATOMIC.search(line)),
                        n_float + bool(hit))
        if hit:
            floats.setdefault(name, []).append(hit.group(0))
    print(f"[build] {lib.name} SASS, kernels {prefix}*: atomics (all, "
          f"float) {counts}", flush=True)
    return floats


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_wgmma<128>`` for the mangled name of that instance."""
    m = re.search(r"(flash_fwd_\w+?)ILi(\d+)E", mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled


def _cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and Path(cand).exists():
            return cand
    spec = importlib.util.find_spec("triton")
    for loc in (spec.submodule_search_locations or []) if spec else []:
        cand = Path(loc) / "backends" / "nvidia" / "bin" / "cuobjdump"
        if cand.exists():
            return str(cand)
    return None


def flash_report():
    """ptxas's registers and spills, the granted shared memory and the
    HGMMA count of each flash_attention kernel; fails if the bf16 kernel
    at Dh=128 has no HGMMA or a bf16 kernel spills."""
    import ctypes

    from repro_torch.kernels.build import BUILD_DIR, load
    smem = load("flash_attention").flash_attention_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    ptxas = ptxas_report("flash_attention", _kernel_name)
    lines = sass_lines(BUILD_DIR / "libflash_attention.so")
    hgmma, top_reg = {}, {}
    if lines is None:
        print("[build] no cuobjdump on this machine (toolkit or triton): "
              "the HGMMA check of flash_attention was not made", flush=True)
    for mangled, line in lines or []:
        name = _kernel_name(mangled)
        hgmma[name] = hgmma.get(name, 0) + ("HGMMA" in line)
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
        top_reg[name] = max([top_reg.get(name, -1), *regs])
    for name in sorted(n for n in set(ptxas) | set(hgmma) if "<" in n):
        dh = int(re.search(r"<(\d+)>", name).group(1))
        bf16 = "wgmma" in name
        info = ptxas.get(name, {})
        print(f"[build] {name} ({'bf16' if bf16 else 'f32'}): ptxas "
              f"{info.get('used', 'not reported')}; "
              f"{info.get('spills', 'spills not reported')}; dynamic shared "
              f"memory {smem(dh, int(bf16))} B; SASS: HGMMA "
              f"{hgmma.get(name, 'not counted')}, highest register "
              f"R{top_reg.get(name, '?')}"
              + (f"; {info['warning']}" if "warning" in info else ""),
              flush=True)
        spilled = re.search(r"(\d+) bytes spill stores", info.get("spills", ""))
        if bf16 and spilled and int(spilled.group(1)) > 0:
            fail(f"{name} spills registers: {info['spills']}")
    if lines is not None and not hgmma.get("flash_fwd_wgmma<128>"):
        fail("the bf16 flash_attention kernel at Dh=128 has no HGMMA in its "
             "SASS")


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
    # 4,096-row chunk and the 128-row tail chunk of a serving step, a whole
    # training batch, and the F=602 contract
    cases = [("serve_step", 4224, 98000, 100, torch.float32, True),
             ("chunk", 4096, 98000, 100, torch.float32, True),
             ("chunk_tail", 128, 98000, 100, torch.float32, True),
             ("train_batch", 75489, 98000, 100, torch.float32, True),
             ("f602_f32", 37, 1000, 602, torch.float32, False),
             ("f602_bf16", 37, 1000, 602, torch.bfloat16, False),
             ("f37_bf16", 37, 1000, 37, torch.bfloat16, False)]  # 2-byte words
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > L2
    rate = hbm_rate(torch.cuda.get_device_name(0))
    one = torch.zeros(1, device=dev)
    print(f"[time] harness floor: a one-float zero_ takes "
          f"{time_ms(torch, one.zero_, flush)} ms here  [{stamp}]", flush=True)
    max_err, timed_at = 0.0, {}
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
        _profile(torch, lambda: cache_gather(slots, cache), stamp,
                 f"cache_gather {label}", calls=PROFILE_CALLS)
        print(f"[time] cache_gather {label} n={n} F={F}: kernel "
              f"{t['ms']} ms, plain {t['plain_ms']} ms, index_select "
              f"{t['library_ms']} ms, bytes bound {t['bound_ms']} ms "
              f"({nbytes} B at {rate / 1e12} TB/s); wrapper host cost "
              f"{call_us:.1f} us/call  [{stamp}]", flush=True)
        timed_at[label] = t
    return {"name": "cache_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gather.cu",
            "replaces": "src/repro/kernels/gather/kernel.py:39",
            "max_abs_err": max_err, "bound_by": "bytes", **timed_at["chunk"],
            **{f"{k}_ms": timed_at[k]["ms"] for k in ("chunk_tail",
                                                      "train_batch")}}


def phase_slice(torch, stamp: str) -> dict:
    """The serving slice at full width; returns the launch counts."""
    import numpy as np

    from repro_torch.core.sampling import NeighborSampler
    from repro_torch.graph.batch import generate_batch, inference_arrays
    from repro_torch.launch.serve import build_parser, run_gnn_serve
    from repro_torch.models.gnn import gnn_forward
    from repro_torch.models.params import leaves

    args = build_parser().parse_args(SERVE_ARGS)
    buf = io.StringIO()
    counts = _zero_counts()
    with contextlib.redirect_stdout(buf):
        rep = run_gnn_serve(args)
    torch.cuda.synchronize()
    launches = counts()
    for line in buf.getvalue().splitlines():
        print(f"{line}  [{stamp}]", flush=True)
    if launches["reservoir_topm"] != 0:       # no serving path selects on it
        fail(f"serving launched {launches}")

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
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.kernels.gather.ops import cache_gather
    from repro_torch.kernels.reservoir.ops import reservoir_topm
    from repro_torch.kernels.segment_agg.ops import (neighbor_agg,
                                                     neighbor_agg_backward)
    fns = {"cache_gather": cache_gather, "gather_aggregate": gather_aggregate,
           "neighbor_agg": neighbor_agg,
           "neighbor_agg_backward": neighbor_agg_backward,
           "flash_attention": flash_attention,
           "reservoir_topm": reservoir_topm}
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
            "neighbor_agg": 2 * steps, "neighbor_agg_backward": 2 * steps,
            "flash_attention": 0, "reservoir_topm": 0}
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
        want = {"cache_gather": 0, "flash_attention": 0, "reservoir_topm": 0,
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
    runs = []                          # (loss, grads): card, card, CPU
    for dev in ("cuda", "cuda", "cpu"):
        params = init_params(tr.decls, torch.Generator().manual_seed(
            args.seed), dev)
        flat = [p.requires_grad_(True) for p in leaves(params)]
        loss, _ = gnn_loss_allfused(
            params, enc.to(dev), aux.to(dev), table.to(dev),
            [i.to(dev) for i in batch["neigh_idxs"]],
            batch["labels"].to(dev), cfg)
        grads = torch.autograd.grad(loss, flat)
        runs.append((float(loss.detach()), [x.cpu() for x in grads]))
    (card_loss, card_grads), (_, again), (cpu_loss, cpu_grads) = runs
    names = _leaf_names(tr.params)
    differ = [n for n, a, b in zip(names, card_grads, again)
              if not torch.equal(a, b)]
    print(f"[check] two fused {ARCH} steps on the card from the same "
          f"parameters and batch: gradients bit-equal={not differ}"
          + (f" (first differing parameter {differ[0]}, {len(differ)} of "
             f"{len(names)} differ)" if differ else
             f" ({len(names)} parameters)"), flush=True)
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
    return {"launches": launches, "batch": batch, "graph": g, "mb": mb,
            "weight_fn": tr.weight_fn, "fanout": cfg.fanout}


def _leaf_names(tree, prefix: str = "") -> list:
    """Dotted names of ``models.params.leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix.rstrip(".")]


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
    rows = device_rows(prof)
    if not rows:
        fail("the profiler recorded no device time over 4 fused steps")
    busy_ms = sum(r[1] for r in rows) / 4e3
    top = "; ".join(f"{k[:60]} {t / 4e3:.3f} ms/step ({c // 4}/step)"
                    for k, t, c in rows[:10])
    print(f"[profile] 4 fused steps: device busy {busy_ms:.3f} ms/step "
          f"(kernels and copies summed), {100 * busy_ms / (step_s * 1e3):.2f}"
          f"% of the {step_s * 1e3:.1f} ms steady step; top: {top}  "
          f"[{stamp}]", flush=True)


def device_rows(prof) -> list:
    """(name, device µs, count) of the device-side events of a profile
    (kernels, copies, memsets), largest first."""
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)),
             e.count) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])


def _bag_inputs(torch, idx, h):
    """``F.embedding_bag`` form of a padded fanout: −1 → an appended zero
    row at index Ns, which ``padding_idx`` leaves out of the reduction."""
    ns = h.shape[0]
    bag = torch.where(idx < 0, torch.full_like(idx, ns), idx).long()
    return bag, torch.cat([h, torch.zeros_like(h[:1])])


def parent_backward(torch, source):
    """The parent commit's ``neighbor_agg`` backward, built from
    ``csrc/segment_agg.cu`` as ``git show HEAD~1`` gives it (or from the
    file ``source`` names) into ``build/repro_torch/parent/`` and bound with
    ctypes: a function ``(idx, dout, h, mode, w) -> (dh, dw)``, or None
    where neither the history nor ``source`` is at hand.  Its SASS's float
    atomics are counted, which shows that phase 1's check finds them."""
    import ctypes

    from repro_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, _nvcc
    out = BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    src, lib_path = out / "segment_agg.cu", out / "libsegment_agg.so"
    if source:
        shutil.copyfile(source, src)
    else:
        try:
            got = subprocess.run(
                ["git", "-C", str(ROOT), "show",
                 "HEAD~1:src/repro_torch/kernels/csrc/segment_agg.cu"],
                capture_output=True, text=True, timeout=60)
        except FileNotFoundError:
            got = None
        if got is None or got.returncode != 0:
            print("[time] the parent's neighbor_agg backward is not timed: "
                  "no git history here and no --parent-source", flush=True)
            return None
        src.write_text(got.stdout)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.neighbor_agg_bwd_launch
    # two C interfaces: the atomic kernel's (no scratch), and since the
    # bucket design one with a scratch buffer sized by the library
    scratch_bytes = getattr(lib, "neighbor_agg_bwd_scratch_bytes", None)
    if scratch_bytes is not None:
        scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_longlong]
        scratch_bytes.restype = ctypes.c_longlong
    pointers = 6 if scratch_bytes is None else 7
    fn.argtypes = ([ctypes.c_void_p] * pointers
                   + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    floats = float_atomics(lib_path, "agg_bwd" if scratch_bytes is None
                           else "bwd_")
    print(f"[build] the parent's backward ({src.name}): float atomics in its "
          f"SASS {None if floats is None else sum(map(len, floats.values()))}",
          flush=True)

    def run(idx, dout, h, mode, w):
        (nd, fan), (ns, d) = idx.shape, h.shape
        dh = torch.empty_like(h)
        dw = None if w is None else torch.empty_like(w)
        buf = (None if scratch_bytes is None else torch.empty(
            scratch_bytes(nd, fan, ns), dtype=torch.uint8, device=h.device))
        scratch = [] if buf is None else [buf.data_ptr()]
        err = fn(idx.data_ptr(), dout.data_ptr(), h.data_ptr(),
                 None if w is None else w.data_ptr(), dh.data_ptr(),
                 None if dw is None else dw.data_ptr(), *scratch, nd, fan,
                 ns, d, 2 if w is not None else {"mean": 0, "sum": 1}[mode],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"the parent's neighbor_agg backward: CUDA error {err}")
        return dh, dw
    return run


def phase_agg(torch, stamp: str, batch: dict, launches: dict,
              parent_source) -> list:
    """gather_aggregate and neighbor_agg at the first batch's shapes, held
    against their plain versions and timed (the backward beside the
    parent's); returns the JSON entries."""
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
    parent = parent_backward(torch, parent_source)
    fwd_err, bwd_err, entry = 0.0, 0.0, None
    for label, idx, ns, d, mode, timed in cases:
        h, dout = rnd(ns, d), rnd(idx.shape[0], d)
        w = (torch.rand(idx.shape, generator=g, device=dev)
             if mode == "weighted" else None)
        m = "sum" if w is not None else mode
        out = neighbor_agg(idx, h, m, w)
        dh, dw = neighbor_agg_backward(idx, dout, h, m, w)
        dh2, dw2 = neighbor_agg_backward(idx, dout, h, m, w)
        ref = neighbor_agg_ref(idx, h, m, w)
        # the backward's oracle: the plain version on the CPU (index_add_ in
        # ascending entry order), which dh must equal bit for bit
        dh_c, dw_c = neighbor_agg_bwd_ref(
            idx.cpu(), dout.cpu(), h.cpu(), m, None if w is None else w.cpu())
        torch.cuda.synchronize()
        err_f = float((out - ref).abs().max())
        ok_f = bool(torch.allclose(out, ref, atol=1e-5, rtol=1e-5))
        exact = torch.equal(dh.cpu(), dh_c)
        again = torch.equal(dh, dh2) and (w is None or torch.equal(dw, dw2))
        rel_w = _close(dw.cpu(), dw_c) if w is not None else 0.0
        err_b = float((dh.cpu() - dh_c).abs().max())
        fwd_err, bwd_err = max(fwd_err, err_f), max(bwd_err, err_b)
        valid = idx >= 0
        seg = torch.bincount(idx[valid].clamp(max=ns - 1).long(), minlength=ns)
        seg = seg[seg > 0]
        over = seg > 32
        print(f"[kernel] neighbor_agg {label} {mode} idx {tuple(idx.shape)} "
              f"h ({ns}, {d}): forward max_abs_err={err_f} (tolerance 1e-5); "
              f"backward dh bit-equal to the CPU plain version={exact} "
              f"(max_abs_err={err_b}), two launches bit-equal={again}"
              + (f", dw rel {rel_w:.2e} (tolerance rel 1e-5)" if w is not None
                 else "") + f"; segments: {seg.numel()}, longest "
              f"{int(seg.max()) if seg.numel() else 0}, {int(over.sum())} "
              f"over 32 ({int(seg[over].sum())} of {int(seg.sum())} entries)",
              flush=True)
        if not (ok_f and exact and again and rel_w <= 1e-5):
            fail(f"neighbor_agg {label} disagrees with its plain version")
        if not timed:
            continue
        nd, fan = idx.shape
        nv = int(valid.sum())
        rows = seg.numel()
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
        # the backward beside the parent's, in turns: parent, kernel,
        # kernel, parent
        turns = [time_ms(torch, fn, flush) for fn in (
            lambda: parent(idx, dout, h, m, w),
            lambda: neighbor_agg_backward(idx, dout, h, m, w),
            lambda: neighbor_agg_backward(idx, dout, h, m, w),
            lambda: parent(idx, dout, h, m, w))] if parent else [
            None, time_ms(torch, lambda: neighbor_agg_backward(
                idx, dout, h, m, w), flush), None, None]
        tb = {"ms": turns[1],
              "plain_ms": time_ms(torch, lambda: neighbor_agg_bwd_ref(
                  idx, dout, h, m, w), flush),
              "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                  lib_out, [hp_g], dout, retain_graph=True), flush),
              "bound_ms": bwd_b[0], "bound_by": bwd_b[1],
              "parent_ms": turns[0]}
        _profile(torch, lambda: neighbor_agg_backward(idx, dout, h, m, w),
                 stamp, f"neighbor_agg backward {label}", calls=PROFILE_CALLS)
        print(f"[time] neighbor_agg {label} {mode} idx ({nd}, {fan}) h "
              f"({ns}, {d}), {nv} valid entries, {rows} distinct rows: "
              f"forward kernel {tf['ms']} ms, plain {tf['plain_ms']} ms, "
              f"embedding_bag {tf['library_ms']} ms (max diff {lib_err}), "
              f"{fwd_b[1]} bound {fwd_b[0]} ms ({fb} B); backward kernel "
              f"{tb['ms']} ms, plain {tb['plain_ms']} ms, embedding_bag "
              f"autograd {tb['library_ms']} ms, {bwd_b[1]} bound "
              f"{bwd_b[0]} ms ({bb} B); turns parent / kernel / kernel / "
              f"parent {turns} ms  [{stamp}]", flush=True)
        if label == "hop1":
            entry = {**tf, **{f"backward_{k}": v for k, v in tb.items()}}
    na = {"name": "neighbor_agg", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/segment_agg.cu",
          "replaces": "src/repro/kernels/segment_agg/kernel.py:56",
          "launches": launches["neighbor_agg"],
          "backward_launches": launches["neighbor_agg_backward"],
          "max_abs_err": fwd_err, "backward_max_abs_err": bwd_err, **entry}
    return [ga, na]


def hop_buckets(graph, dst_ids, fanout: int, weight_fn, rng) -> list:
    """The rows that ``NeighborSampler._sample_one_hop`` hands to top-m
    selection for ``dst_ids``, in its own buckets (``topm_buckets``): a list
    of ``(width, w, u, mask)``, ``w`` the bias weights of each row's
    neighbours and ``u`` uniforms from ``rng``, both (R, width) float32,
    ``mask`` (R, width) bool (``col < size``)."""
    import numpy as np

    from repro_torch.core.sampling import hop_edges, topm_buckets
    indptr, indices = graph.adj()
    nb_all, row_start, sizes = hop_edges(indptr, indices, dst_ids)
    w_all = weight_fn(nb_all)
    return [(src.shape[1], w_all[src].astype(np.float32),
             rng.random(valid.shape, dtype=np.float32), valid)
            for _, src, valid in topm_buckets(sizes, row_start, fanout)]


def inclusion_probability(w):
    """Exact inclusion probability of each lane in a weighted sample of 2
    without replacement: p_i = w_i/W + Σ_{j≠i} (w_j/W)·w_i/(W − w_j)."""
    W = sum(w)
    return [wi / W + sum(wj / W * wi / (W - wj)
                         for j, wj in enumerate(w) if j != i)
            for i, wi in enumerate(w)]


def _reservoir_odd_cases(torch, dev, g, weight_fn, rng) -> list:
    """(label, m, w, u, mask) on the card: the hub row unpadded (m = 5, 10
    and 40, the last past the per-thread list of 32), N = 37, m > N,
    all-masked rows and a wide row with fewer valid lanes than m, exact
    ties from duplicated u, u = 0 lanes and int32 masks."""
    import numpy as np
    indptr, indices = g.adj()
    hub = int(np.argmax(np.diff(indptr)))
    nb = indices[indptr[hub]:indptr[hub + 1]]

    def rand(R, N, density=0.8, mask_dtype=bool):
        w = rng.uniform(0.5, 4.0, (R, N)).astype(np.float32)
        u = rng.random((R, N), dtype=np.float32)
        return w, u, (rng.random((R, N)) < density).astype(mask_dtype)

    def ties(R, N):
        w = np.where(rng.random((R, N)) < 0.5, 1.0, 4.0).astype(np.float32)
        u = np.array([0.0, 0.2, 0.5, 0.7, 0.9], np.float32)[
            rng.integers(0, 5, (R, N))]
        return w, u, rng.random((R, N)) < 0.9

    hub_in = (weight_fn(nb)[None].astype(np.float32),
              rng.random((1, len(nb)), dtype=np.float32),
              np.ones((1, len(nb)), bool))
    cases = [(f"hub_n{len(nb)}_m{m}", m, *hub_in) for m in (5, 10, 40)]
    cases += [("n37", 5, *rand(13, 37)), ("m_gt_n", 9, *rand(4, 5)),
              ("n1", 3, *rand(6, 1)),
              ("sparse_wide_m40", 40, *rand(3, 4096, density=0.005)),
              ("ties", 10, *ties(64, 256)), ("ties_wide", 15, *ties(4, 8192)),
              ("int32_mask", 10, *rand(13, 100, mask_dtype=np.int32)),
              ("int32_mask_wide", 15, *rand(5, 1500, mask_dtype=np.int32))]
    w, u, mask = rand(8, 64)
    mask[3] = False
    cases.append(("all_masked_row", 5, w, u, mask))
    w, u, mask = rand(3, 2048)
    mask[1] = False
    cases.append(("all_masked_row_wide", 10, w, u, mask))
    w, u, mask = rand(32, 128)
    u[rng.random(u.shape) < 0.3] = 0.0
    cases.append(("u_zero", 10, w, u, mask))
    return [(label, m, *(torch.from_numpy(x).to(dev) for x in xs))
            for label, m, *xs in cases]


def phase_reservoir(torch, stamp: str, train: dict) -> dict:
    """reservoir_topm at the sampler's hop shapes: every bucket of hops 2
    and 3 of the first full-width batch (each hop's launches counted), the
    hub row and odd shapes, each bit-exact against the plain version on the
    card; the inclusion frequencies of 2^20 rows against the exact
    probabilities; each bucket timed as in phase 2 and each hop's sum
    beside the host numpy time of that hop's ``_sample_one_hop``.  Returns
    the JSON entry."""
    import numpy as np

    from repro_torch.core.sampling import NeighborSampler
    from repro_torch.kernels.reservoir.ops import reservoir_topm
    from repro_torch.kernels.reservoir.ref import NEG, reservoir_topm_ref
    dev = torch.device("cuda")
    rate = hbm_rate(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    g, mb, weight_fn = train["graph"], train["mb"], train["weight_fn"]
    rng = np.random.default_rng(0)
    hops = {}
    for hop in (2, 3):                      # hop 1 is nearest the output
        m = train["fanout"][hop - 1]
        dst = mb.blocks[-hop].dst_ids
        cases = [(f"hop{hop}_w{width}", m,
                  *(torch.from_numpy(x).to(dev) for x in (w, u, mask)))
                 for width, w, u, mask in hop_buckets(g, dst, m, weight_fn,
                                                      rng)]
        hops[hop] = {"m": m, "dst": dst, "cases": cases}

    # the counted runs: one launch per bucket, as a GPU sampler would issue,
    # each hop counted on its own
    outs, hop_launches = {}, {}
    for hop, h in hops.items():
        torch.cuda.synchronize()
        counts = _zero_counts()
        outs[hop] = [reservoir_topm(w, u, mask, m)
                     for _, m, w, u, mask in h["cases"]]
        torch.cuda.synchronize()
        launches = counts()
        want = {k: 0 for k in launches}
        want["reservoir_topm"] = len(h["cases"])
        print(f"[reservoir] hop {hop} of the first batch: {len(h['cases'])} "
              f"buckets, launches {launches} (expected {want})", flush=True)
        if launches != want:
            fail(f"reservoir hop {hop} launches {launches}, expected {want}")
        hop_launches[hop] = launches["reservoir_topm"]

    max_err = 0.0

    def check(label, m, w, u, mask, got):
        nonlocal max_err
        idx, keys = got
        r_idx, r_keys = reservoir_topm_ref(w, u, mask, m)
        torch.cuda.synchronize()
        exact = (torch.equal(idx, r_idx)
                 and torch.equal(keys.view(torch.int32),
                                 r_keys.view(torch.int32)))
        err = float((keys - r_keys).abs().max())
        max_err = max(max_err, err)
        spent = int((idx == w.shape[1]).sum())
        print(f"[kernel] reservoir_topm {label} ({w.shape[0]}, {w.shape[1]}) "
              f"m={m} mask {mask.dtype}: bit-exact={exact} (idx equal, keys "
              f"equal bit for bit), max_abs_err={err}, {spent} exhausted "
              f"slots", flush=True)
        if not exact or not bool((keys[idx == w.shape[1]] == NEG).all()):
            fail(f"reservoir_topm disagrees with its plain version at {label}")

    for hop, h in hops.items():
        for case, got in zip(h["cases"], outs[hop]):
            check(*case, got)
    for case in _reservoir_odd_cases(torch, dev, g, weight_fn, rng):
        check(*case, reservoir_topm(*case[2:], case[1]))

    # inclusion frequencies of w = [4, 4, 1, 1, 1, 1, 1, 1], m = 2
    T = 1 << 20
    wd = [4.0, 4.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    gen = torch.Generator(device=dev).manual_seed(0)
    idx, _ = reservoir_topm(
        torch.tensor(wd, device=dev).expand(T, 8).contiguous(),
        torch.rand((T, 8), generator=gen, device=dev),
        torch.ones((T, 8), dtype=torch.bool, device=dev), 2)
    freq = (torch.bincount(idx.flatten().long(), minlength=9).cpu().numpy()
            / T)
    p = np.array(inclusion_probability(wd))
    z = np.abs(freq[:8] - p) / np.sqrt(p * (1 - p) / T)
    print(f"[kernel] reservoir_topm distribution over {T} rows of {wd}, "
          f"m=2: frequency {freq[:8].round(5).tolist()} against exact "
          f"{p.round(5).tolist()}, largest |z| {z.max():.2f} (tolerance 5)",
          flush=True)
    if z.max() > 5 or freq[8] != 0:
        fail("reservoir_topm inclusion frequencies differ from the exact "
             "probabilities")

    totals = {}
    for hop, h in hops.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "padded_bound_ms": 0.0}
        rows = lanes = 0
        for label, m, w, u, mask in h["cases"]:
            R, N = w.shape
            km = (torch.log(u.clamp(min=1e-30)) / w.clamp(min=1e-9)
                  ).masked_fill(~mask, NEG)
            # the mask is read whole; w and u only where it is set (a masked
            # lane's key is thrown away); idx and keys written once
            valid = int(mask.sum())
            nbytes = R * N * mask.element_size() + 8 * valid + 8 * R * m
            padded = R * N * (8 + mask.element_size()) + 8 * R * m
            t = {"ms": time_ms(torch, lambda: reservoir_topm(w, u, mask, m),
                               flush),
                 "plain_ms": time_ms(torch, lambda: reservoir_topm_ref(
                     w, u, mask, m), flush),
                 "library_ms": time_ms(torch, lambda: torch.topk(km, m, dim=1),
                                       flush),
                 "bound_ms": nbytes / rate * 1e3,
                 "padded_bound_ms": padded / rate * 1e3}
            for k in tot:
                tot[k] += t[k]
            rows, lanes = rows + R, lanes + R * N
            print(f"[time] reservoir_topm {label} ({R}, {N}) m={m}: kernel "
                  f"{t['ms']} ms, plain {t['plain_ms']} ms, torch.topk over "
                  f"precomputed keys (selection only) {t['library_ms']} ms, "
                  f"bytes bound {t['bound_ms']} ms ({nbytes} B, {valid} "
                  f"valid lanes, at {rate / 1e12} TB/s; {t['padded_bound_ms']}"
                  f" ms counting w and u of every padded lane)  [{stamp}]",
                  flush=True)
        sampler = NeighborSampler(g, train["fanout"], weight_fn=weight_fn,
                                  seed=0)
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            sampler._sample_one_hop(h["dst"], h["m"])
            host.append((time.perf_counter() - t0) * 1e3)
        tot["host_numpy_ms"] = float(np.median(host))
        tot["launches"] = hop_launches[hop]
        totals[hop] = tot
        print(f"[time] reservoir_topm hop {hop} (m={h['m']}), sum over "
              f"{len(h['cases'])} buckets ({rows} rows, {lanes} lanes): "
              f"kernel {tot['ms']} ms, plain {tot['plain_ms']} ms, "
              f"torch.topk (selection only) {tot['library_ms']} ms, bytes "
              f"bound {tot['bound_ms']} ms (valid lanes; "
              f"{tot['padded_bound_ms']} ms padded), launches "
              f"{tot['launches']}; host numpy time of the hop's "
              f"_sample_one_hop on the same {len(h['dst'])} rows (keys, "
              f"buckets and selection), median of 5: {tot['host_numpy_ms']} "
              f"ms  [{stamp}]", flush=True)
    t3 = totals[3]
    return {"name": "reservoir_topm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/reservoir.cu",
            "replaces": "src/repro/kernels/reservoir/kernel.py:45",
            "launches": t3["launches"], "max_abs_err": max_err,
            "ms": t3["ms"], "plain_ms": t3["plain_ms"],
            "bound_ms": t3["bound_ms"], "bound_by": "bytes",
            "library_ms": t3["library_ms"],
            "host_numpy_ms": t3["host_numpy_ms"], "hop2": totals[2]}


def _bf16_bound_rejects_faults(torch, out, q, k, v):
    """The bf16 check must refuse the kernel's causal output with one KV
    tile dropped from the last query block, and with the normaliser of the
    later rows 3% off; else it could not tell such a kernel from rounding."""
    from repro_torch.kernels.flash_attention.ref import bf16_excess
    B, S, H, Dh = q.shape
    r0, lo = S - 64, S // 2
    G = H // k.shape[2]
    kf, vf = (x.float().repeat_interleave(G, dim=2) for x in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:].float(), kf) * Dh ** -0.5
    key = torch.arange(S, device=q.device)
    row = torch.arange(r0, S, device=q.device)[:, None]
    keep = (key <= row) & ((key < lo) | (key >= lo + 64))
    p = torch.softmax(sc.masked_fill(~keep, -1e30), dim=-1)
    skipped = out.clone()
    skipped[:, r0:] = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(out.dtype)
    renormed = out.clone()
    renormed[:, S // 2:] = (out[:, S // 2:].float() * 1.03).to(out.dtype)
    for fault, bad in ((f"keys {lo}..{lo + 63} skipped for rows {r0}.."
                        f"{S - 1}", skipped),
                       (f"rows {S // 2}.. scaled by 1.03", renormed)):
        elem, row_x = bf16_excess(bad, q, k, v, True)
        print(f"[kernel] flash_attention bf16 bound on a faulty output "
              f"({fault}): element {elem:.3f}, row {row_x:.3f} of their "
              f"limits (must exceed 1)", flush=True)
        if max(elem, row_x) <= 1:
            fail(f"the bf16 check of flash_attention passes a faulty output "
                 f"({fault})")


def phase_flash(torch, stamp: str) -> dict:
    """flash_attention at the LM slice's shapes against its plain version,
    timed at the qwen3-4b and llama3.2-3b prefills; returns the JSON entry
    (the qwen3-4b prefill's numbers, the llama3.2-3b one's beside them)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (bf16_excess,
                                                         flash_attention_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rate = hbm_rate(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    B, S = PREFILL_SHAPE
    # (label, B, S, H, Hkv, Dh, dtype, causal, timed): the two prefills;
    # the edges of the bf16 kernel's 128-row tiles (a partial diagonal, one
    # row past a tile, a partial last KV tile) and its Dh=64 instance; odd
    # lengths, f32 and non-causal
    bf16 = torch.bfloat16
    cases = [("qwen3_prefill", B, S, 32, 8, 128, bf16, True, True),
             ("llama3_prefill", B, S, 24, 8, 128, bf16, True, True),
             ("s127_bf16", 1, 127, 32, 8, 128, bf16, True, False),
             ("s129_bf16", 1, 129, 32, 8, 128, bf16, True, False),
             ("s4097_bf16", 1, 4097, 32, 8, 128, bf16, True, False),
             ("s1000_dh64_bf16", 1, 1000, 32, 8, 64, bf16, True, False),
             ("s37_f32", 1, 37, 32, 8, 128, torch.float32, True, False),
             ("s1000_f32", 1, 1000, 32, 8, 128, torch.float32, True, True),
             ("s256_full_f32", 1, 256, 32, 32, 128, torch.float32, False,
              False),
             ("s256_full_bf16", 1, 256, 32, 32, 128, torch.bfloat16, False,
              False)]
    max_err, timed_at = 0.0, {}
    for label, b, s, h, hkv, dh, dtype, causal, timed in cases:
        q = torch.randn((b, s, h, dh), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((b, s, hkv, dh), generator=g, device=dev).to(dtype)
                for _ in range(2))
        out = flash_attention(q, k, v, causal)
        ref = flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        max_err = max(max_err, err)
        if dtype == torch.bfloat16:
            elem, row = bf16_excess(out, q, k, v, causal)
            ok = max(elem, row) <= 1
            how = (f"bf16 bound: element {elem:.3f}, row {row:.3f} of their "
                   f"limits")
        else:
            ok = err <= FLASH_F32_ATOL
            how = f"tolerance {FLASH_F32_ATOL}"
        print(f"[kernel] flash_attention {label} q ({b}, {s}, {h}, {dh}) kv "
              f"heads {hkv} {dtype} causal={causal}: max_abs_err={err} "
              f"({how})", flush=True)
        if not (ok and bool(torch.isfinite(out).all())):
            fail(f"flash_attention disagrees with its plain version at "
                 f"{label}")
        if label == "qwen3_prefill":
            _bf16_bound_rejects_faults(torch, out, q, k, v)
        if not timed:
            continue
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4 * b * h * dh * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
        t_f, t_b = flops / peak * 1e3, nbytes / rate * 1e3
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # (B, H, S, Dh)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=hkv != h)
        lib_err = float((lib().transpose(1, 2).float() - ref.float()).abs().max())
        t = {"ms": time_ms(torch, lambda: flash_attention(q, k, v, causal),
                           flush),
             "plain_ms": time_ms(torch, lambda: flash_attention_ref(
                 q, k, v, causal), flush),
             "library_ms": time_ms(torch, lib, flush),
             "bound_ms": max(t_f, t_b),
             "bound_by": "operations" if t_f >= t_b else "bytes"}
        print(f"[time] flash_attention {label} q ({b}, {s}, {h}, {dh}) kv "
              f"heads {hkv} {dtype}: kernel {t['ms']} ms "
              f"({flops / t['ms'] / 1e9:.1f} TFLOP/s, "
              f"{t['bound_ms'] / t['ms']:.1%} of the bound), plain "
              f"{t['plain_ms']} ms, scaled_dot_product_attention "
              f"{t['library_ms']} ms ({flops / t['library_ms'] / 1e9:.1f} "
              f"TFLOP/s, {t['bound_ms'] / t['library_ms']:.1%} of the bound; "
              f"max diff {lib_err}); bound {t['bound_ms']} ms by "
              f"{t['bound_by']}: {flops} FLOP at {peak / 1e12} TFLOP/s = "
              f"{t_f} ms, {nbytes} B at {rate / 1e12} TB/s = {t_b} ms  "
              f"[{stamp}]", flush=True)
        timed_at[label] = t
    llama = timed_at["llama3_prefill"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:60",
            "max_abs_err": max_err, **timed_at["qwen3_prefill"],
            "llama3_2_3b_prefill": {k: llama[k] for k in (
                "ms", "library_ms", "bound_ms")}}


def _profile(torch, fn, stamp: str, label: str, calls: int = 1):
    """Device time per call of ``fn`` by kernel (``torch.profiler``), over a
    window of ``calls`` calls. A window of a few microseconds of device work
    now and then comes back with no device events, so an empty window is
    profiled again, up to ``PROFILE_TRIES`` windows, before the phase fails."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows:
            break
        print(f"[profile] {label}: window {attempt} of {PROFILE_TRIES} "
              f"recorded no device time", flush=True)
    else:
        fail(f"the profiler recorded no device time over {label} in "
             f"{PROFILE_TRIES} windows")
    busy = sum(r[1] for r in rows) / 1e3 / calls
    top = "; ".join(f"{k[:60]} {t / 1e3 / calls:.3f} ms ({c / calls:g})"
                    for k, t, c in rows[:8])
    print(f"[profile] {label}: device busy {busy:.3f} ms per call over "
          f"{calls} call(s); top: {top}  [{stamp}]", flush=True)


def phase_lm(torch, stamp: str) -> dict:
    """The LM serving slice at full width; returns the launch counts of the
    prefill and of the serving run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.serve import build_parser, run_lm_serve
    from repro_torch.models import layers
    from repro_torch.models.api import build, compute_params
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import Engine, Request

    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    model = build(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model.decls, gen, dev)
    cparams = compute_params(params, cfg)
    torch.cuda.synchronize()
    print(f"[lm] {LM_ARCH} full width, {cfg.num_layers} layers: "
          f"{cfg.param_count()} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s (f32 masters and a bf16 copy); "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated  "
          f"[{stamp}]", flush=True)

    B, S = PREFILL_SHAPE
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device=dev)}
    with torch.no_grad():
        model.prefill(cparams, batch)                 # warm-up, not counted
        torch.cuda.synchronize()
        counts = _zero_counts()
        t0 = time.perf_counter()
        logits, caches = model.prefill(cparams, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        prefill_launches = counts()
    want = {"cache_gather": 0, "gather_aggregate": 0, "neighbor_agg": 0,
            "neighbor_agg_backward": 0, "flash_attention": cfg.num_layers,
            "reservoir_topm": 0}
    print(f"[lm] prefill tokens ({B}, {S}): {dt * 1e3:.1f} ms, "
          f"{B * S / dt:.0f} tokens/s; launches {prefill_launches} (expected "
          f"{want})  [{stamp}]", flush=True)
    if prefill_launches != want:
        fail(f"prefill launches {prefill_launches}, expected {want}")
    kv_shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim)
    if not (logits.shape == (B, cfg.vocab_size)
            and bool(torch.isfinite(logits).all())
            and tuple(caches["k"].shape) == kv_shape):
        fail(f"prefill logits {tuple(logits.shape)} (finite: "
             f"{bool(torch.isfinite(logits).all())}), caches "
             f"{tuple(caches['k'].shape)}")
    del caches, logits
    with torch.no_grad():
        _profile(torch, lambda: model.prefill(cparams, batch), stamp,
                 f"one prefill of ({B}, {S})")
    del cparams

    args = build_parser().parse_args(LM_SERVE_ARGS)
    buf = io.StringIO()
    counts = _zero_counts()
    with contextlib.redirect_stdout(buf):
        rep = run_lm_serve(args, params=params)
    torch.cuda.synchronize()
    serve_launches = counts()
    for line in buf.getvalue().splitlines():
        print(f"{line}  [{stamp}]", flush=True)
    eng, st = rep["engine"], rep["stats"]
    done = eng.completed
    if not (st["completed"] == args.requests == len(done)
            and all(r.status == "done" and len(r.out_tokens) == args.max_new
                    and all(0 <= t < cfg.vocab_size for t in r.out_tokens)
                    for r in done)):
        fail(f"{st['completed']}/{args.requests} requests completed")
    if any(serve_launches.values()):
        fail(f"serving launched {serve_launches}: decode is plain torch")
    # one decode step with every slot busy at position max_len / 2
    step = {"token": torch.ones(args.batch, dtype=torch.int32, device=dev),
            "pos": torch.full((args.batch,), args.max_len // 2,
                              dtype=torch.int32, device=dev)}
    times = []
    with torch.no_grad():
        for _ in range(20):
            t0 = time.perf_counter()
            lg, _ = eng.model.decode(eng._cparams, eng.kv.caches, step)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(lg).all()):
            fail("decode-step logits are not finite")
        _profile(torch, lambda: eng.model.decode(eng._cparams, eng.kv.caches,
                                                 step), stamp,
                 f"one decode step at batch {args.batch}")
    print(f"[lm] serving {args.requests} requests at batch {args.batch}: "
          f"{st['tokens']} tokens in {st['seconds']:.2f} s, "
          f"{st['tokens_per_s']:.1f} tokens/s; TTFT p50 "
          f"{st['ttft_p50_ms']:.1f} ms p99 {st['ttft_p99_ms']:.1f} ms; "
          f"decode step (batch {args.batch}, position {args.max_len // 2}) "
          f"median of 20 {float(np.median(times)):.2f} ms; launches "
          f"{serve_launches}  [{stamp}]", flush=True)
    del eng, rep

    # f32 on a 64-token prompt: the kernel's prefill against the plain
    # version's, and the engine's first greedy token against its argmax
    cfg32 = cfg.replace(compute_dtype="float32")
    m32 = build(cfg32)
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, 64
                                               ).astype(np.int32)
    toks = {"tokens": torch.from_numpy(prompt)[None].to(dev)}
    with torch.no_grad():
        got, _ = m32.prefill(params, toks)
        kernel = layers.flash_attention
        layers.flash_attention = flash_attention_ref
        try:
            want_logits, _ = m32.prefill(params, toks)
        finally:
            layers.flash_attention = kernel
    rel = float((got - want_logits).abs().max() / want_logits.abs().max())
    eng = Engine(cfg32, params=params, batch=1, max_len=128, device=dev)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=1))
    eng.run_to_completion()
    first, top = eng.completed[0].out_tokens[0], int(got[0].argmax())
    print(f"[check] f32 prefill of 64 tokens: kernel vs plain attention max "
          f"|diff| / max |logit| = {rel:.2e} (tolerance "
          f"{LOGITS_REL_TOL}); engine first token {first}, prefill argmax "
          f"{top}", flush=True)
    if not (rel <= LOGITS_REL_TOL and bool(torch.isfinite(got).all())):
        fail("the f32 prefill through the kernel differs from the plain one")
    if first != top:
        fail("the engine's first token is not the prefill's argmax")
    return {"prefill": prefill_launches, "serve": serve_launches}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", default=None,
                    help="csrc/segment_agg.cu of the parent commit, where "
                         "this checkout has no git history")
    args = ap.parse_args()
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
                                  train["launches"], args.parent_source)
    flash = phase_flash(torch, stamp)
    lm = phase_lm(torch, stamp)
    reservoir = phase_reservoir(torch, stamp, train)
    flash["launches"] = lm["prefill"]["flash_attention"]
    flash["decode_launches"] = lm["serve"]["flash_attention"]
    reservoir["path_launches"] = {
        "gnn_serve": launches["reservoir_topm"],
        "train": train["launches"]["reservoir_topm"],
        "lm_prefill": lm["prefill"]["reservoir_topm"],
        "lm_serve": lm["serve"]["reservoir_topm"]}
    entries += [flash, reservoir]
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
