#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py [--parent-source PATH [PATH ...]]

Phases; any failure exits non-zero:

1. build — compile every CUDA source of the port (one ``nvcc`` each, all
   started together) and print the seconds it took; then, for each
   ``flash_attention`` kernel, ``ptxas``'s registers and spills and the
   dynamic shared memory its launch grants, and the count of ``HGMMA``
   instructions in each kernel's SASS (``cuobjdump -sass`` of the built
   library); ``ptxas``'s registers, spills and shared memory of every
   ``neighbor_agg``, ``gather_aggregate``, ``cache_gather`` and
   ``reservoir_topm`` kernel, and the atomics in the SASS of the
   ``neighbor_agg`` backward's and the ``reservoir_topm`` kernels.  Fails
   if the bf16 kernel at Dh=128 has no ``HGMMA``, if a bf16 or reservoir
   kernel spills, or if the backward or a reservoir kernel adds a float
   atomically; a machine with no ``cuobjdump`` gets a line saying so;
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
   of that first batch, plus GAT's weighted shapes, odd widths and the
   fused read's miss path (the batch's ``enc`` re-encoded so that half its
   distinct rows come from the sideband): held against their plain
   versions (``h_dst`` and the backward's ``dh`` bit-equal, the backward
   against the plain version on the CPU, two launches bit-equal), the
   forwards' means and sums bit-equal to the reference order written out,
   and every output bit-equal to the parent commit's kernels (built from
   ``git show HEAD~1``, or from ``--parent-source``: a directory holding
   its ``segment_agg.cu``, ``fused_gather_agg.cu`` and ``reservoir.cu``, or
   its checkout root, or the three files);
   each hop's segment lengths printed; each timed as in phase 2, with
   ``F.embedding_bag`` as the yardstick of ``neighbor_agg``, in turns
   with the parent's kernel (parent, kernel, kernel, parent), and each
   profiled over ``PROFILE_CALLS`` calls for its own device time;
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
   bit-exact (idx, and keys bit for bit) against its plain version and
   against the parent commit's kernel with the hub row and odd shapes;
   inclusion frequencies of 2^20 rows against the exact probabilities (5
   standard errors); each bucket timed as in phase 2, in turns with the
   parent's kernel (parent, kernel, kernel, parent), with ``torch.topk``
   over precomputed keys as the yardstick of the selection alone and the
   bytes bound over valid lanes (w and u read where the mask is set; the
   padded-lane figure printed beside it); the hub row's time on a line of
   its own, its device time and that of the bucket of most rows profiled;
   each hop's sums (kernel, parent, ``torch.topk``, bound) beside the host
   numpy time of its ``_sample_one_hop``.  Phases 3, 4, 7 and 9 launch it
   0 times: no path of the port, as none of the JAX package, selects on
   the card;
9. the multi-partition slice at full width — ``repro_torch.launch.train
   --arch graphsage-products --partitions 2 --halo-budget 4096
   --sampling-device device --fused-gather-agg --steps 8`` through
   ``run_gnn`` (a locality plan with a bounded halo, 8 gradient-synchronised
   global steps of two partitions on the card under ``fit_supervised``
   with a checkpoint every 4, then a fresh trainer that restores the
   committed checkpoint), launch counts zeroed just before and read just
   after (``gather_aggregate`` partitions × global steps, ``neighbor_agg``
   and its backward that × 2 hops, nothing else).  It prints the plan, the
   host seconds of planning, global steps/s, each partition's stage split,
   the checkpoint write and restore seconds, the modeled memory, accuracy
   and the hit rates, and fails unless: the restored trainer's params and
   ``opt_state`` are ``torch.equal`` to the writer's and to the committed
   npz, with ``global_steps`` and the cache and halo statistics back, and
   one further global step runs; the first global step's all-reduced
   gradient on the card is within rel 1e-4 of the CPU's from the same
   parameters and batches; every halo row in each partition's device plane
   is bit-equal to the owner's row; ``fit_supervised`` with a failure
   injected at step 3 of 4 ends at step 4 with one failure and one
   restore; and a 4-step unfused run launches one ``cache_gather`` per
   chunk of each partition's plane fetch and no other kernel.  It also
   prints the device time by kernel of 2 warm global steps
   (``torch.profiler``) against the median of 3 un-profiled ones.
   Checkpoints go to temporary directories that the phase removes;
10. the online auto-tuner at full width — (a) ``repro_torch.launch.train
   --arch graphsage-products --sampling-device device --fused-gather-agg
   --autotune --episodes-autotune 4 --steps 10`` through ``run_gnn``, launch
   counts zeroed just before and read just after (2 warm-up and 4 × 10
   fused steps: ``gather_aggregate`` 42, ``neighbor_agg`` and its backward
   84 each, nothing else); per episode the configuration, the measured
   throughput, memory and accuracy, the hit rate, the surrogate's predicted
   point and the host seconds of PROPOSE, RECONFIGURE and MEASURE (the
   controller's ``propose``, ``_apply_config`` and ``measure``, wrapped by
   this script); the PPO agent's parameters on the card, and one PPO update
   on the card within 1e-5 of the same update on the CPU; (b) one
   controller (``tune_sampling_device``, ``max_partitions=2``,
   ``max_halo_budget=4096``) on a fresh full-width trainer: the plane
   flipped device → cpu → device over one cache, one fused step from one
   state and batch on each plane, losses and updated parameters bit-equal
   (``gather_aggregate``'s table path against its all-sideband path); a
   restart to 2 partitions with a 4096-row halo (params and ``opt_state``
   ``torch.equal`` across it; the checkpoint write, planning and restore
   seconds) and a 4-global-step episode; the halo budget swapped live to
   0 on the same trainer; a restart back to 1 partition, again
   ``torch.equal``, and one step;
11. the serving fabric at full width — (a) ``repro_torch.launch.serve
   --gnn --arch graphsage-products --sampling-device device --partitions 2
   --replicas 2 --train-steps 4 --queries 64 --batch 4 --slo-p99-ms 600``
   through ``run_gnn_serve``: 4 warm-up global steps, each replica stepped
   once, 64 queries, a trainer step with ``refresh_weights`` and a
   re-query, a 512-query burst; the launch counts zeroed just before and
   read just after, and each part's ``cache_gather`` launches (the
   launcher's per-part counts) equal to the gather chunks its planes
   issued, no other kernel launched.  It prints the plan and its planning
   seconds, q/s, p50 and p99, the per-partition and per-replica counts,
   the burst's shed fraction and deferrals and the host time of a fabric
   step split into its engines' sample, fetch, pad and forward (the
   fabric's ``step`` and the engine's stages wrapped by this script), and
   fails unless the load is served whole with finite logits, each query by
   a replica of its owner, the audit balances, every replica held the
   warm tree until the hand-off and the re-query's logits are bit-equal to
   a fresh engine's forward with the trainer's new tree on the same batch,
   and the burst both sheds and serves; (b) chaos: two fabrics of SimHost
   replicas on a ``VirtualClock`` (``from_plan`` on the plan re-budgeted to
   a 4,096-row halo, 2 ms a response, timeout 8 ms, replica 0/0 killed
   after its 3rd response, 48 queries 4 a step) and a twin on the CPU from
   the same parameters: the audit balanced, 0/0 down with timeouts and
   retries, the two card runs' traces identical and logits bit-equal, the
   CPU's (rid, partition, replica, status) trace identical with equal
   predictions and logits within 1e-4, one launch per gather chunk, and
   every halo row resident in each card plane, bit-equal to the owner's.

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
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ARCH = "graphsage-products"
SERVE_ARGS = ["--gnn", "--arch", ARCH, "--sampling-device", "device",
              "--train-steps", "4", "--queries", "64", "--batch", "4"]
TRAIN_ARGS = ["--arch", ARCH, "--sampling-device", "device",
              "--fused-gather-agg", "--steps", "8"]
MULTIPART_ARGS = ["--arch", ARCH, "--partitions", "2", "--halo-budget",
                  "4096", "--sampling-device", "device", "--fused-gather-agg",
                  "--steps", "8"]
FABRIC_ARGS = ["--gnn", "--arch", ARCH, "--sampling-device", "device",
               "--partitions", "2", "--replicas", "2", "--train-steps", "4",
               "--queries", "64", "--batch", "4", "--slo-p99-ms", "600"]
FABRIC_HALO = 4096               # the chaos fabrics' plan: halo rows kept
CHAOS_QUERIES = 48
AUTOTUNE_EPISODES, AUTOTUNE_STEPS = 4, 10
AUTOTUNE_ARGS = ["--arch", ARCH, "--sampling-device", "device",
                 "--fused-gather-agg", "--autotune", "--episodes-autotune",
                 str(AUTOTUNE_EPISODES), "--steps", str(AUTOTUNE_STEPS)]
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
    gnn_report("fused_gather_agg")
    gnn_report("gather")
    for name, info in gnn_report("reservoir").items():
        spilled = re.search(r"(\d+) bytes spill stores", info.get("spills", ""))
        if spilled and int(spilled.group(1)) > 0:
            fail(f"reservoir {name} spills registers: {info['spills']}")
    for lib, prefix, what in (("segment_agg", "bwd_", "the neighbor_agg "
                               "backward"), ("reservoir", "topm_",
                                             "reservoir_topm")):
        floats = float_atomics(BUILD_DIR / f"lib{lib}.so", prefix)
        if floats is None:
            print(f"[build] no cuobjdump on this machine (toolkit or "
                  f"triton): the float-atomic check of {what} was not made",
                  flush=True)
        elif floats:
            fail(f"{what} adds floats atomically: {floats}")


def _short_name(mangled: str) -> str:
    """``bwd_short_kernel<4,2>`` / ``cache_gather_kernel<uint4,4>`` /
    ``topm_chunk_kernel<4,u8>`` for the mangled name of a GNN or
    reservoir kernel instance."""
    m = re.search(r"\d+((?:bwd|agg|cache|gather|topm)_\w+?_kernel)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end():].split("EEv")[0] + "E"
    word = re.match(r"I(t|j|5uint4)", rest)
    args = ([{"t": "u16", "j": "u32", "5uint4": "uint4"}[word.group(1)]]
            if word else [])
    args += re.findall(r"Li(\d+)E", rest) if rest.startswith("I") else []
    mask = re.search(r"E([hi])E$", rest) if m.group(1).startswith("topm") \
        else None
    args += [{"h": "u8", "i": "i32"}[mask.group(1)]] if mask else []
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


def gnn_report(lib: str) -> dict:
    """ptxas's registers and spills of each kernel of ``csrc/<lib>.cu``,
    printed and returned by kernel."""
    report = ptxas_report(lib, _short_name)
    for name, info in sorted(report.items()):
        print(f"[build] {lib}: {name}: ptxas {info.get('used', 'not reported')}"
              f"; {info.get('spills', 'spills not reported')}", flush=True)
    return report


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


PARENT_SOURCES = ("segment_agg.cu", "fused_gather_agg.cu", "reservoir.cu")


def _parent_paths(source: list) -> dict:
    """The parent's kernel sources named by ``--parent-source``: a
    directory that holds them (or a checkout root, with them under
    ``src/repro_torch/kernels/csrc/``), or the files themselves."""
    paths = [Path(x) for x in source]
    if len(paths) == 1 and paths[0].is_dir():
        for where in (paths[0], paths[0] / "src/repro_torch/kernels/csrc"):
            found = {n: where / n for n in PARENT_SOURCES}
            if all(x.is_file() for x in found.values()):
                return found
        fail(f"--parent-source {paths[0]} holds no {' and '.join(PARENT_SOURCES)}")
    found = {x.name: x for x in paths}
    if sorted(found) != sorted(PARENT_SOURCES) or not all(
            x.is_file() for x in found.values()):
        fail(f"--parent-source names a directory or the files "
             f"{' and '.join(PARENT_SOURCES)}, not {source}")
    return found


def parent_kernels(torch, source):
    """The parent commit's ``neighbor_agg`` (forward and backward),
    ``gather_aggregate`` and ``reservoir_topm``, built from
    ``csrc/segment_agg.cu``, ``csrc/fused_gather_agg.cu`` and
    ``csrc/reservoir.cu`` as ``git show HEAD~1`` gives them (or as
    ``source``, the ``--parent-source`` list, names them) into
    ``build/repro_torch/parent/`` (one ``nvcc`` each, started together) and
    bound with ctypes.  Returns a namespace of ``forward(idx, h, mode, w)``,
    ``backward(idx, dout, h, mode, w) -> (dh, dw)``,
    ``gather_aggregate(enc, idx, table, aux, mode) -> (h_dst, agg)`` and
    ``reservoir_topm(w, u, mask, m) -> (idx, keys)``, or None where neither
    the history nor ``source`` is at hand.  The backward's SASS float
    atomics are counted, which shows that phase 1's check finds them in a
    kernel that has them."""
    import ctypes
    import types

    from repro_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, _nvcc
    out = BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    if source:
        for name, path in _parent_paths(source).items():
            shutil.copyfile(path, out / name)
    else:
        for name in PARENT_SOURCES:
            try:
                got = subprocess.run(
                    ["git", "-C", str(ROOT), "show",
                     f"HEAD~1:src/repro_torch/kernels/csrc/{name}"],
                    capture_output=True, text=True, timeout=60)
            except FileNotFoundError:
                got = None
            if got is None or got.returncode != 0:
                print("[time] the parent's kernels are neither timed nor "
                      "compared: no git history here and no --parent-source",
                      flush=True)
                return None
            (out / name).write_text(got.stdout)
    procs = [(name, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(out / f"lib{Path(name).stem}.so"),
         str(out / name)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for name in PARENT_SOURCES]
    for name, proc in procs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"the parent's {name} does not build:\n{log}")
    seg = ctypes.CDLL(str(out / "libsegment_agg.so"))
    ga_fn = ctypes.CDLL(str(out / "libfused_gather_agg.so")).gather_aggregate_launch
    ga_fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                      + [ctypes.c_int] + [ctypes.c_longlong] * 3
                      + [ctypes.c_int, ctypes.c_void_p])
    fwd_fn = seg.neighbor_agg_fwd_launch
    fwd_fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    bwd_fn = seg.neighbor_agg_bwd_launch
    # two backward interfaces: the atomic kernel's (no scratch), and since
    # the bucket design one with a scratch buffer sized by the library
    scratch_bytes = getattr(seg, "neighbor_agg_bwd_scratch_bytes", None)
    if scratch_bytes is not None:
        scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_longlong]
        scratch_bytes.restype = ctypes.c_longlong
    pointers = 6 if scratch_bytes is None else 7
    bwd_fn.argtypes = ([ctypes.c_void_p] * pointers
                       + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    for fn in (ga_fn, fwd_fn, bwd_fn):
        fn.restype = ctypes.c_int
    res = ctypes.CDLL(str(out / "libreservoir.so"))
    res_fn = res.reservoir_topm_launch
    # two interfaces: a launch of (R, N, m) alone, and since the chunked
    # design one given the launcher's layout, its scratch and counters
    res_bytes = getattr(res, "reservoir_topm_scratch_bytes", None)
    if res_bytes is None:
        res_fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                           + [ctypes.c_void_p] * 2
                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
    else:
        res_bytes.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 7
        res_bytes.restype = ctypes.c_longlong
        res_fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                           + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3)
    res_fn.restype = ctypes.c_int
    res_counters = []    # the new interface's row counters, kept zeroed
    floats = float_atomics(out / "libsegment_agg.so",
                           "agg_bwd" if scratch_bytes is None else "bwd_")
    print(f"[build] the parent's kernels ({', '.join(PARENT_SOURCES)}): float "
          f"atomics in its backward's SASS "
          f"{None if floats is None else sum(map(len, floats.values()))}",
          flush=True)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def code(mode, w):
        return 2 if w is not None else {"mean": 0, "sum": 1}[mode]

    def forward(idx, h, mode, w):
        (nd, fan), (ns, d) = idx.shape, h.shape
        out_ = torch.empty((nd, d), dtype=h.dtype, device=h.device)
        err = fwd_fn(ptr(idx), ptr(h), ptr(w), ptr(out_), nd, fan, ns, d,
                     code(mode, w), stream())
        if err:
            fail(f"the parent's neighbor_agg forward: CUDA error {err}")
        return out_

    def backward(idx, dout, h, mode, w):
        (nd, fan), (ns, d) = idx.shape, h.shape
        dh = torch.empty_like(h)
        dw = None if w is None else torch.empty_like(w)
        buf = (None if scratch_bytes is None else torch.empty(
            scratch_bytes(nd, fan, ns), dtype=torch.uint8, device=h.device))
        scratch = [] if buf is None else [buf.data_ptr()]
        err = bwd_fn(ptr(idx), ptr(dout), ptr(h), ptr(w), ptr(dh), ptr(dw),
                     *scratch, nd, fan, ns, d, code(mode, w), stream())
        if err:
            fail(f"the parent's neighbor_agg backward: CUDA error {err}")
        return dh, dw

    def gather_aggregate(enc, idx, table, aux, mode):
        (nd, fan), (c, f) = idx.shape, table.shape
        h_dst = torch.empty((nd, f), dtype=table.dtype, device=table.device)
        agg = torch.empty((nd, f), dtype=table.dtype, device=table.device)
        err = ga_fn(ptr(enc), ptr(idx), ptr(table), ptr(aux), ptr(h_dst),
                    ptr(agg), enc.shape[0], nd, fan, c, aux.shape[0], f,
                    {"mean": 0, "sum": 1}[mode], stream())
        if err:
            fail(f"the parent's gather_aggregate: CUDA error {err}")
        return h_dst, agg

    def reservoir_topm(w, u, mask, m):
        from repro_torch.kernels.reservoir.ops import layout
        (R, N), dev = w.shape, w.device
        mask_bytes = mask.element_size()
        mask = mask.view(torch.uint8) if mask_bytes == 1 else mask
        idx = torch.empty((R, m), dtype=torch.int32, device=dev)
        keys = torch.empty((R, m), dtype=torch.float32, device=dev)
        args = [ptr(w), ptr(u), ptr(mask), mask_bytes, ptr(idx), ptr(keys),
                R, N, m]
        if res_bytes is not None:    # this launcher's layout for its kernel
            plan = layout(N)
            buf = torch.empty(max(res_bytes(R, N, m, *plan), 0),
                              dtype=torch.uint8, device=dev)
            if not res_counters or res_counters[0].numel() < R:
                res_counters[:] = [torch.zeros(R, dtype=torch.int32,
                                               device=dev)]
            args += [*plan, ptr(buf), ptr(res_counters[0])]
        err = res_fn(*args, stream())
        if err:
            fail(f"the parent's reservoir_topm: CUDA error {err}")
        return idx, keys
    return types.SimpleNamespace(forward=forward, backward=backward,
                                 gather_aggregate=gather_aggregate,
                                 reservoir_topm=reservoir_topm)


def _in_order(torch, rows, idx, mode: str):
    """The reference order written out, on the card: from +0, acc = acc +
    where(valid_f, row_f, 0) over ascending f, then / max(cnt, 1) for the
    mean; f32, one rounding per operation.  Indices past the rows clamp."""
    valid = idx >= 0
    safe = idx.clamp(0, rows.shape[0] - 1).long()
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    acc = torch.zeros((idx.shape[0], rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for f in range(idx.shape[1]):
        acc = acc + torch.where(valid[:, f, None], rows[safe[:, f]], zero)
    if mode == "mean":
        acc = acc / valid.sum(1, keepdim=True).clamp(min=1).to(rows.dtype)
    return acc


def _half_from_sideband(torch, enc, table, aux):
    """``enc`` re-encoded so that every other distinct slot it names is read
    from the sideband instead: ``(enc', aux')``, ``aux'`` being ``aux``
    followed by those slots' rows.  Every id resolves to the same row as
    before (entries already in the sideband, padding among them, keep their
    rows)."""
    slots = torch.unique(enc[enc >= 0])
    moved = slots[::2]
    where = torch.full((table.shape[0],), -1, dtype=torch.int64,
                       device=enc.device)
    where[moved] = torch.arange(moved.numel(), device=enc.device)
    at = where[enc.clamp(min=0).long()]
    enc2 = torch.where((enc >= 0) & (at >= 0),
                       (-(aux.shape[0] + at) - 1).to(enc.dtype), enc)
    return enc2.contiguous(), torch.cat([aux, table[moved]]).contiguous()


def _turns(torch, new, old, flush) -> list:
    """``old`` / ``new`` / ``new`` / ``old``, each timed as in phase 2;
    None in the parent's slots where there is no parent."""
    if old is None:
        return [None, time_ms(torch, new, flush), time_ms(torch, new, flush),
                None]
    return [time_ms(torch, fn, flush) for fn in (old, new, new, old)]


def phase_agg(torch, stamp: str, batch: dict, launches: dict,
              parent) -> list:
    """gather_aggregate and neighbor_agg at the first batch's shapes (and a
    re-encoding of the batch with half its rows in the sideband), held
    against their plain versions, against the reference order written out
    and bit for bit against the parent commit's kernels, and timed (the
    forwards and the backward in turns with the parent's); returns the JSON
    entries."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.kernels.fused_gather_agg.ref import (gather_aggregate_ref,
                                                          resolve_rows_ref)
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

    # -- gather_aggregate: layer 0 (mean: graphsage/gcn; sum: gin), with
    # every row resident (as the trainer runs it) and with half the
    # distinct rows re-encoded into the sideband (the miss path) ----------
    idx0 = idxs[0]
    nd, fan = idx0.shape
    f = table.shape[1]
    enc_m, aux_m = _half_from_sideband(torch, enc, table, aux)
    ga_cases = {"resident": (enc, aux), "half_sideband": (enc_m, aux_m)}
    ga_err, timed_ga = 0.0, {}
    for label, (e, x) in ga_cases.items():
        for mode in ("mean", "sum"):
            h, a = gather_aggregate(e, idx0, table, x, mode=mode)
            h_r, a_r = gather_aggregate_ref(e, idx0, table, x, mode=mode)
            order = _in_order(torch, resolve_rows_ref(e, table, x), idx0, mode)
            old = (None if parent is None
                   else parent.gather_aggregate(e, idx0, table, x, mode))
            torch.cuda.synchronize()
            exact = torch.equal(h, h_r)
            err = float((a - a_r).abs().max())
            ok = bool(torch.allclose(a, a_r, atol=1e-5, rtol=1e-5))
            same_order = torch.equal(a, order)
            same_parent = old is None or (torch.equal(h, old[0])
                                          and torch.equal(a, old[1]))
            ga_err = max(ga_err, err)
            print(f"[kernel] gather_aggregate {label} {mode} enc "
                  f"({e.shape[0]},) ({int((e < 0).sum())} from the sideband) "
                  f"idx {tuple(idx0.shape)} table {tuple(table.shape)} aux "
                  f"{tuple(x.shape)}: h_dst bit-exact={exact}, agg "
                  f"max_abs_err={err} (tolerance 1e-5), agg bit-equal to the "
                  f"reference order={same_order}, both outputs bit-equal to "
                  f"the parent's kernel="
                  f"{'not compared' if old is None else same_parent}",
                  flush=True)
            if not (exact and ok and same_order and same_parent):
                fail(f"gather_aggregate {label} {mode} disagrees")
        # bytes the call needs: the distinct rows it resolves, the enc
        # entries it reads, the indices, and the two outputs
        valid = idx0 >= 0
        refs = torch.cat([torch.arange(nd, device=dev), idx0[valid].long()])
        pos = torch.unique(refs)
        rows = int(torch.unique(e[pos]).numel())
        nbytes = rows * f * 4 + pos.numel() * 4 + nd * fan * 4 + 2 * nd * f * 4
        b_ms, b_by = bound(nbytes, int(valid.sum()) * f)
        t = _turns(torch, lambda: gather_aggregate(e, idx0, table, x),
                   None if parent is None else
                   lambda: parent.gather_aggregate(e, idx0, table, x, "mean"),
                   flush)
        plain = time_ms(torch, lambda: gather_aggregate_ref(e, idx0, table, x),
                        flush)
        _profile(torch, lambda: gather_aggregate(e, idx0, table, x), stamp,
                 f"gather_aggregate {label} mean", calls=PROFILE_CALLS)
        print(f"[time] gather_aggregate {label} mean idx {tuple(idx0.shape)} "
              f"F={f}: kernel {t[1]} ms, plain {plain} ms, no library call, "
              f"{b_by} bound {b_ms} ms ({nbytes} B: {rows} distinct rows); "
              f"turns parent / kernel / kernel / parent {t} ms  [{stamp}]",
              flush=True)
        timed_ga[label] = {"ms": t[1], "plain_ms": plain, "bound_ms": b_ms,
                           "bound_by": b_by, "parent_ms": t[0]}
    ga = {"name": "gather_aggregate", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/fused_gather_agg.cu",
          "replaces": "src/repro/kernels/fused_gather_agg/kernel.py:63",
          "launches": launches["gather_aggregate"], "max_abs_err": ga_err,
          "library_ms": None, **timed_ga["resident"],
          "half_sideband_ms": timed_ga["half_sideband"]["ms"],
          "half_sideband_parent_ms": timed_ga["half_sideband"]["parent_ms"]}

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
    fwd_err, bwd_err, entry = 0.0, 0.0, {}
    for label, idx, ns, d, mode, timed in cases:
        h, dout = rnd(ns, d), rnd(idx.shape[0], d)
        w = (torch.rand(idx.shape, generator=g, device=dev)
             if mode == "weighted" else None)
        m = "sum" if w is not None else mode
        out = neighbor_agg(idx, h, m, w)
        dh, dw = neighbor_agg_backward(idx, dout, h, m, w)
        dh2, dw2 = neighbor_agg_backward(idx, dout, h, m, w)
        ref = neighbor_agg_ref(idx, h, m, w)
        # the forward's oracles: the reference order written out (mean and
        # sum; the weighted multiply-add is one fma in the kernels, two
        # roundings in torch) and the parent's kernel, bit for bit
        order = _in_order(torch, h, idx, m) if w is None else None
        old = None if parent is None else parent.forward(idx, h, m, w)
        # the backward's oracle: the plain version on the CPU (index_add_ in
        # ascending entry order), which dh must equal bit for bit
        dh_c, dw_c = neighbor_agg_bwd_ref(
            idx.cpu(), dout.cpu(), h.cpu(), m, None if w is None else w.cpu())
        torch.cuda.synchronize()
        err_f = float((out - ref).abs().max())
        ok_f = bool(torch.allclose(out, ref, atol=1e-5, rtol=1e-5))
        same_order = order is None or torch.equal(out, order)
        same_parent = old is None or torch.equal(out, old)
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
              f"h ({ns}, {d}): forward max_abs_err={err_f} (tolerance 1e-5), "
              f"bit-equal to the reference order="
              f"{'weighted: not compared' if order is None else same_order}, "
              f"to the parent's kernel="
              f"{'not compared' if old is None else same_parent}; "
              f"backward dh bit-equal to the CPU plain version={exact} "
              f"(max_abs_err={err_b}), two launches bit-equal={again}"
              + (f", dw rel {rel_w:.2e} (tolerance rel 1e-5)" if w is not None
                 else "") + f"; segments: {seg.numel()}, longest "
              f"{int(seg.max()) if seg.numel() else 0}, {int(over.sum())} "
              f"over 32 ({int(seg[over].sum())} of {int(seg.sum())} entries)",
              flush=True)
        if not (ok_f and same_order and same_parent and exact and again
                and rel_w <= 1e-5):
            fail(f"neighbor_agg {label} disagrees")
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
        # each direction beside the parent's kernel, in turns: parent,
        # kernel, kernel, parent
        f_turns = _turns(torch, lambda: neighbor_agg(idx, h, m, w),
                         None if parent is None else
                         lambda: parent.forward(idx, h, m, w), flush)
        tf = {"ms": f_turns[1],
              "plain_ms": time_ms(torch, lambda: neighbor_agg_ref(
                  idx, h, m, w), flush),
              "library_ms": time_ms(torch, lib, flush),
              "bound_ms": fwd_b[0], "bound_by": fwd_b[1],
              "parent_ms": f_turns[0]}
        b_turns = _turns(torch, lambda: neighbor_agg_backward(
            idx, dout, h, m, w), None if parent is None else
            lambda: parent.backward(idx, dout, h, m, w), flush)
        tb = {"ms": b_turns[1],
              "plain_ms": time_ms(torch, lambda: neighbor_agg_bwd_ref(
                  idx, dout, h, m, w), flush),
              "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                  lib_out, [hp_g], dout, retain_graph=True), flush),
              "bound_ms": bwd_b[0], "bound_by": bwd_b[1],
              "parent_ms": b_turns[0]}
        _profile(torch, lambda: neighbor_agg(idx, h, m, w), stamp,
                 f"neighbor_agg forward {label}", calls=PROFILE_CALLS)
        _profile(torch, lambda: neighbor_agg_backward(idx, dout, h, m, w),
                 stamp, f"neighbor_agg backward {label}", calls=PROFILE_CALLS)
        print(f"[time] neighbor_agg {label} {mode} idx ({nd}, {fan}) h "
              f"({ns}, {d}), {nv} valid entries, {rows} distinct rows: "
              f"forward kernel {tf['ms']} ms, plain {tf['plain_ms']} ms, "
              f"embedding_bag {tf['library_ms']} ms (max diff {lib_err}), "
              f"{fwd_b[1]} bound {fwd_b[0]} ms ({fb} B), turns parent / "
              f"kernel / kernel / parent {f_turns} ms; backward kernel "
              f"{tb['ms']} ms, plain {tb['plain_ms']} ms, embedding_bag "
              f"autograd {tb['library_ms']} ms, {bwd_b[1]} bound "
              f"{bwd_b[0]} ms ({bb} B), turns parent / kernel / kernel / "
              f"parent {b_turns} ms  [{stamp}]", flush=True)
        if label == "hop1":
            entry.update(tf)
            entry.update({f"backward_{k}": v for k, v in tb.items()})
        else:
            entry.update({f"{label}_{k}": v for k, v in tf.items()
                          if k in ("ms", "bound_ms", "parent_ms")})
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


def reservoir_hops(torch, train: dict, rng) -> dict:
    """Phase 8's buckets: hops 2 and 3 of the first batch, in that order,
    with uniforms from ``rng``: ``{hop: {"m", "dst", "cases"}}``, each case
    ``(label, m, w, u, mask)`` on the card."""
    dev = torch.device("cuda")
    g, mb, weight_fn = train["graph"], train["mb"], train["weight_fn"]
    hops = {}
    for hop in (2, 3):                      # hop 1 is nearest the output
        m = train["fanout"][hop - 1]
        dst = mb.blocks[-hop].dst_ids
        cases = [(f"hop{hop}_w{width}", m,
                  *(torch.from_numpy(x).to(dev) for x in (w, u, mask)))
                 for width, w, u, mask in hop_buckets(g, dst, m, weight_fn,
                                                      rng)]
        hops[hop] = {"m": m, "dst": dst, "cases": cases}
    return hops


def phase_reservoir(torch, stamp: str, train: dict, parent) -> dict:
    """reservoir_topm at the sampler's hop shapes: every bucket of hops 2
    and 3 of the first full-width batch (each hop's launches counted), the
    hub row and odd shapes, each bit-exact against the plain version on the
    card and against the parent commit's kernel (``parent``, from
    ``parent_kernels``; None: not compared); the inclusion frequencies of
    2^20 rows against the exact probabilities; each bucket timed in turns
    with the parent's kernel (parent / kernel / kernel / parent) beside the
    plain version and ``torch.topk``, the widest bucket (the hub row) on a
    line of its own, its device time and that of the bucket of most rows
    profiled, and each hop's sums beside the host numpy time of that hop's
    ``_sample_one_hop``.  Returns the JSON entry."""
    import numpy as np

    from repro_torch.core.sampling import NeighborSampler
    from repro_torch.kernels.reservoir.ops import layout, reservoir_topm
    from repro_torch.kernels.reservoir.ref import NEG, reservoir_topm_ref
    dev = torch.device("cuda")
    rate = hbm_rate(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    g, weight_fn = train["graph"], train["weight_fn"]
    rng = np.random.default_rng(0)
    hops = reservoir_hops(torch, train, rng)

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

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(
            a[1].view(torch.int32), b[1].view(torch.int32))

    def check(label, m, w, u, mask, got):
        nonlocal max_err
        idx, keys = got
        ref = reservoir_topm_ref(w, u, mask, m)
        old = None if parent is None else parent.reservoir_topm(w, u, mask, m)
        torch.cuda.synchronize()
        exact = same(got, ref)
        same_parent = old is None or same(got, old)
        err = float((keys - ref[1]).abs().max())
        max_err = max(max_err, err)
        spent = int((idx == w.shape[1]).sum())
        print(f"[kernel] reservoir_topm {label} ({w.shape[0]}, {w.shape[1]}) "
              f"m={m} mask {mask.dtype} layout "
              f"{tuple(layout(w.shape[1]))}: bit-exact={exact} (idx "
              f"equal, keys equal bit for bit), max_abs_err={err}, {spent} "
              f"exhausted slots; bit-equal to the parent's kernel="
              f"{'not compared' if old is None else same_parent}", flush=True)
        if not (exact and same_parent) or not bool(
                (keys[idx == w.shape[1]] == NEG).all()):
            fail(f"reservoir_topm disagrees with its plain version or the "
                 f"parent's kernel at {label}")

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
        tot = {"ms": 0.0, "parent_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0, "padded_bound_ms": 0.0}
        rows = lanes = 0
        widest = most = None
        for label, m, w, u, mask in h["cases"]:
            R, N = w.shape
            km = (torch.log(u.clamp(min=1e-30)) / w.clamp(min=1e-9)
                  ).masked_fill(~mask, NEG)
            # the mask is read whole; w and u only where it is set (a masked
            # lane's key is thrown away); idx and keys written once
            valid = int(mask.sum())
            nbytes = R * N * mask.element_size() + 8 * valid + 8 * R * m
            padded = R * N * (8 + mask.element_size()) + 8 * R * m
            turns = _turns(
                torch, lambda: reservoir_topm(w, u, mask, m),
                None if parent is None else
                lambda: parent.reservoir_topm(w, u, mask, m), flush)
            t = {"ms": turns[1], "parent_ms": turns[0],
                 "plain_ms": time_ms(torch, lambda: reservoir_topm_ref(
                     w, u, mask, m), flush),
                 "library_ms": time_ms(torch, lambda: torch.topk(km, m, dim=1),
                                       flush),
                 "bound_ms": nbytes / rate * 1e3,
                 "padded_bound_ms": padded / rate * 1e3}
            for k in tot:
                tot[k] = None if t[k] is None or tot[k] is None \
                    else tot[k] + t[k]
            rows, lanes = rows + R, lanes + R * N
            line = (f"{label} ({R}, {N}) m={m} layout "
                    f"{tuple(layout(N))}: kernel {t['ms']} ms, "
                    f"parent {t['parent_ms']} ms (turns parent / kernel / "
                    f"kernel / parent {turns} ms), plain {t['plain_ms']} ms, "
                    f"torch.topk over precomputed keys (selection only) "
                    f"{t['library_ms']} ms, bytes bound {t['bound_ms']} ms "
                    f"({nbytes} B, {valid} valid lanes, at {rate / 1e12} "
                    f"TB/s; {t['padded_bound_ms']} ms counting w and u of "
                    f"every padded lane)")
            print(f"[time] reservoir_topm {line}  [{stamp}]", flush=True)
            if widest is None or N > widest[0]:
                widest = (N, line, (label, m, w, u, mask))
            if most is None or R > most[0]:
                most = (R, (label, m, w, u, mask))
        print(f"[time] reservoir_topm hub row of hop {hop}, {widest[1]}  "
              f"[{stamp}]", flush=True)
        # device time of a call, without the harness: the hub row and the
        # bucket of most rows
        for label, m, w, u, mask in (widest[2], most[1]):
            _profile(torch, lambda: reservoir_topm(w, u, mask, m), stamp,
                     f"reservoir_topm {label} ({w.shape[0]}, {w.shape[1]})",
                     calls=PROFILE_CALLS)
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
              f"kernel {tot['ms']} ms, parent {tot['parent_ms']} ms, plain "
              f"{tot['plain_ms']} ms, torch.topk (selection only) "
              f"{tot['library_ms']} ms, bytes bound {tot['bound_ms']} ms "
              f"(valid lanes; {tot['padded_bound_ms']} ms padded), launches "
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
            "library_ms": t3["library_ms"], "parent_ms": t3["parent_ms"],
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


def _run_multipart(torch, argv: list, stamp: str):
    """``run_gnn`` of ``repro_torch.launch.train`` with ``argv`` and a
    fresh checkpoint directory; the launch counts zeroed just before and
    read just after.  Returns (what run_gnn returns, launches, seconds)."""
    from repro_torch.launch.train import build_parser, run_gnn
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    args = build_parser().parse_args(argv + ["--ckpt-dir", ckpt])
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
    return rep, launches, wall


def phase_multipart(torch, stamp: str) -> dict:
    """The multi-partition slice at full width (phase 9); returns the launch
    counts of the fused run and of the unfused run."""
    import numpy as np

    from repro_torch.core.multipart import MultiPipeline
    from repro_torch.core.pipeline import PipelineStats
    from repro_torch.core.sampling import NeighborSampler, seed_loader
    from repro_torch.distributed.collectives import grad_allreduce
    from repro_torch.graph.batch import (batch_device_arrays,
                                         compute_level_caps)
    from repro_torch.launch.mesh import HostSimMesh
    from repro_torch.models.gnn import make_grad_fn_allfused
    from repro_torch.models.params import init_params, leaves
    from repro_torch.train.checkpoint import CheckpointManager

    rep, launches, wall = _run_multipart(torch, MULTIPART_ARGS, stamp)
    tr, tr2, sup = rep["trainer"], rep["restored"], rep["report"]
    cfg, plan, parts = tr.cfg, tr.plan, tr.plan.parts
    steps = sup.steps_run
    try:
        if not (steps == 8 and sup.checkpoints == 2 and sup.failures == 0
                and tr.global_steps == 8 and parts == 2):
            fail(f"multi-partition run: {sup}, {tr.global_steps} global "
                 f"steps, {parts} partitions")
        layers = cfg.num_layers
        want = {"cache_gather": 0, "gather_aggregate": parts * steps,
                "neighbor_agg": parts * steps * (layers - 1),
                "neighbor_agg_backward": parts * steps * (layers - 1),
                "flash_attention": 0, "reservoir_topm": 0}
        print(f"[multipart] {ARCH} fused, full width, {parts} partitions: "
              f"{steps} global steps under fit_supervised; launches "
              f"{launches} (expected {want}); run_gnn incl. both trainers' "
              f"builds and evaluations {wall:.2f} s  [{stamp}]", flush=True)
        if launches != want:
            fail(f"multi-partition launches {launches}, expected {want}")
        for slot in tr.slots:
            st = slot.pipe.stats
            if (st.steps != steps or len(st.losses) != steps
                    or not all(map(math.isfinite, st.losses))):
                fail(f"partition {slot.index}: {st.steps} steps, losses "
                     f"{st.losses}")
            if slot.pipe.plane.device.type != "cuda":
                fail(f"partition {slot.index}'s plane is on "
                     f"{slot.pipe.plane.device}")
        if not all(p.is_cuda for p in leaves(tr.params)):
            fail("multi-partition parameters are not on cuda")
        secs = rep["seconds"]
        print(f"[multipart] plan: sizes {[len(ns) for ns in plan.node_sets]}, "
              f"edge locality {plan.edge_locality(tr.full_graph)}, kept "
              f"information {plan.kept_information(tr.full_graph)}, halo "
              f"rows kept {[len(hs) for hs in plan.halo_sets]} "
              f"({plan.halo_rows} in all, budget {plan.halo_budget}), "
              f"exchange {tr.halo_exchange_bytes} B; host seconds: planning "
              f"{tr.plan_seconds} (the restored trainer's "
              f"{tr2.plan_seconds}), trainer build {secs['build']} (the "
              f"restored trainer's {secs['rebuild']})  [{stamp}]", flush=True)
        print(f"[multipart] {steps} global steps in {secs['fit']} s: "
              f"{steps / secs['fit']} global steps/s wall clock (the first "
              f"incl. one-time set-up, 2 checkpoint writes incl.)  "
              f"[{stamp}]", flush=True)
        for slot in tr.slots:
            st, n = slot.pipe.stats, max(slot.pipe.stats.steps, 1)
            print(f"[multipart] partition {slot.index}: mean of {st.steps} "
                  f"steps: sample {st.t_sample / n * 1e3:.3f} ms, batch "
                  f"{st.t_batch / n * 1e3:.3f} ms, train "
                  f"{st.t_train / n * 1e3:.3f} ms; losses {st.losses}; "
                  f"cache hit rate {slot.cache.stats.hit_rate}, halo hit "
                  f"rate {slot.halo_stats.hit_rate}  [{stamp}]", flush=True)
        agg = PipelineStats()
        MultiPipeline(tr)._aggregate(agg)
        print(f"[multipart] modeled memory {tr.modeled_memory(agg)} B "
              f"({parts} partitions, {cfg.parallel_mode}); accuracy "
              f"{tr.evaluate()}, restored {tr2.evaluate()}; cache hit rate "
              f"{tr.cache_hit_rate}, halo hit rate {tr.halo_hit_rate}  "
              f"[{stamp}]", flush=True)

        # 1. restore: the restored trainer holds the committed step's state
        mgr = CheckpointManager(rep["ckpt_dir"], async_save=False)
        step = mgr.latest_step()
        with np.load(Path(rep["ckpt_dir"]) / f"step_{step:09d}" /
                     "shard_0.npz") as z:
            on_disk = {k: z[k] for k in z.files}
        from repro_torch.train.checkpoint import _flatten_with_names
        disk_ok = all(
            np.array_equal(on_disk[f"{g}/{n}".replace("/", "__")],
                           x.cpu().numpy() if isinstance(x, torch.Tensor)
                           else np.asarray(x, np.int32))
            for g, tree in tr2.state_dict().items()
            for n, x in _flatten_with_names(tree))
        stats_ok = (
            [s.cache.stats for s in tr2.slots] ==
            [s.cache.stats for s in tr.slots]
            and [s.halo_stats for s in tr2.slots] ==
            [s.halo_stats for s in tr.slots])
        mine, theirs = leaves(tr2.state_dict()), leaves(tr.state_dict())
        equal = len(mine) == len(theirs) and all(
            torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(mine, theirs))
        print(f"[check] restore: step {step}, global_steps "
              f"{tr2.global_steps}, params and opt_state torch.equal to the "
              f"writer's={equal} and to the committed npz={disk_ok}; cache "
              f"and halo statistics back={stats_ok}; restore "
              f"{secs['restore']} s host  [{stamp}]", flush=True)
        if not (step == 8 and tr2.global_steps == 8 and equal and disk_ok
                and stats_ok and all(p.is_cuda for p in leaves(tr2.params))):
            fail("the restored trainer differs from the committed checkpoint")
        counts = _zero_counts()
        tr2.global_step()
        torch.cuda.synchronize()
        after = counts()
        if not (tr2.global_steps == 9 and after["gather_aggregate"] == parts
                and all(math.isfinite(s.pipe.stats.losses[-1])
                        for s in tr2.slots)):
            fail(f"the global step after the restore: {after}, "
                 f"global_steps {tr2.global_steps}")
        save_dir = tempfile.mkdtemp(prefix="chip_smoke_save_")
        try:
            t0 = time.perf_counter()
            tr.save(CheckpointManager(save_dir, async_save=False), step=8)
            t_save = time.perf_counter() - t0
        finally:
            shutil.rmtree(save_dir, ignore_errors=True)
        nbytes = sum(np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                else x).nbytes
                     for x in leaves(tr.state_dict()))
        print(f"[multipart] checkpoint write (synchronous, {nbytes} B of "
              f"params and opt_state) {t_save} s, restore {secs['restore']} "
              f"s; one global step after the restore: launches {after}  "
              f"[{stamp}]", flush=True)

        # 2. the first global step's all-reduced gradient, card against CPU,
        # from the initial parameters (re-drawn from the seed) and the two
        # partitions' first batches (re-derived as each pipeline drew them)
        batches = []
        for slot in tr.slots:
            g = slot.graph
            seeds = next(iter(seed_loader(g, cfg.batch_size,
                                          tr.seed + slot.index)))
            mb = NeighborSampler(g, cfg.fanout, weight_fn=slot.weight_fn,
                                 seed=tr.seed + slot.index).sample(seeds)
            caps = compute_level_caps(len(seeds), cfg.fanout, g.num_nodes)
            arrays = batch_device_arrays(mb, level_caps=caps)
            enc, aux, table = slot.pipe.plane.fused_inputs(
                mb.input_ids, arrays["pads"][0])
            batches.append({
                "inputs": (enc.cpu(), aux.cpu(), table.cpu(),
                           [torch.from_numpy(i) for i in arrays["neigh_idxs"]],
                           torch.from_numpy(arrays["labels"])),
                "n": len(mb.input_ids)})
        means, losses = {}, {}
        for label, dev in (("card", "cuda"), ("host", "cpu")):
            params = init_params(tr.decls, torch.Generator().manual_seed(
                tr.seed), dev)
            gfn = make_grad_fn_allfused(cfg)
            grads, ls = [], []
            for b in batches:
                enc, aux, table, idxs, labels = b["inputs"]
                gr, loss, _ = gfn(params, enc.to(dev), aux.to(dev),
                                  table.to(dev), [i.to(dev) for i in idxs],
                                  labels.to(dev))
                grads.append(gr)
                ls.append(float(loss))
            means[label] = [x.cpu() for x in
                            leaves(grad_allreduce(HostSimMesh(parts))(grads))]
            losses[label] = ls
        grad_rel = max(_close(a, b) for a, b in zip(means["card"],
                                                    means["host"]))
        run_first = [s.pipe.stats.losses[0] for s in tr.slots]
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(losses["card"] + run_first,
                           losses["host"] + losses["host"]))
        print(f"[check] first global step, input ids "
              f"{[b['n'] for b in batches]}: losses cuda {losses['card']} "
              f"cpu {losses['host']} (the run's first {run_first}); "
              f"all-reduced gradient cuda vs cpu rel {grad_rel:.2e}, losses "
              f"rel {loss_rel:.2e} (tolerance 1e-4)", flush=True)
        if not (grad_rel <= 1e-4 and loss_rel <= 1e-4):
            fail("the first global step on the card differs from the CPU "
                 "beyond 1e-4")

        # 3. halo rows in each partition's device plane equal the owner's
        owner_local = plan.local_ids()
        halo_ok = []
        for slot, ns, hs in zip(tr.slots, plan.node_sets, plan.halo_sets):
            local = np.arange(len(ns), len(ns) + len(hs))
            resident = int(slot.cache.is_cached(local).sum())
            got = slot.pipe.plane.fetch(local)
            want_rows = np.stack([plan.subgraphs[q].features[owner_local[v]]
                                  for q, v in zip(plan.owner[hs], hs)])
            halo_ok.append((len(hs), resident,
                            bool(np.array_equal(got, want_rows))))
        print(f"[check] halo rows (rows, resident on the card, bit-equal to "
              f"the owner's) per partition: {halo_ok}", flush=True)
        if not all(ok and n == res for n, res, ok in halo_ok):
            fail(f"halo rows in the device planes: {halo_ok}")

        # 4. the failure path on the same trainer, in a new directory
        fail_dir = tempfile.mkdtemp(prefix="chip_smoke_fail_")
        counts = _zero_counts()
        try:
            t0 = time.perf_counter()
            frep = tr.fit_supervised(4, fail_dir, ckpt_every=2,
                                     fail_at_step=3)
            torch.cuda.synchronize()
            t_fail = time.perf_counter() - t0
        finally:
            shutil.rmtree(fail_dir, ignore_errors=True)
        fl = counts()
        print(f"[check] failure path: fit_supervised(4, fail_at_step=3): "
              f"{frep}; launches {fl}; {t_fail} s  [{stamp}]", flush=True)
        if not (frep.final_step == 4 and frep.failures == 1
                and frep.restores == 1 and frep.steps_run == 5
                and fl["gather_aggregate"] == parts * frep.steps_run):
            fail(f"failure path: {frep}, launches {fl}")

        # device busy share of a warm global step: 3 un-profiled steps on
        # the host clock, then 2 profiled ones for the device time by kernel
        from torch.profiler import ProfilerActivity, profile
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            tr.global_step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                tr.global_step()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if not rows:
            fail("the profiler recorded no device time over 2 global steps")
        busy_ms = sum(r[1] for r in rows) / 2e3
        step_ms = float(np.median(walls)) * 1e3
        top = "; ".join(f"{k[:60]} {t / 2e3:.3f} ms/step ({c // 2}/step)"
                        for k, t, c in rows[:8])
        print(f"[profile] 2 warm global steps: device busy {busy_ms:.3f} "
              f"ms/step (kernels and copies summed), {100 * busy_ms / step_ms:.2f}"
              f"% of the {step_ms:.1f} ms median un-profiled global step "
              f"(of 3: {[round(w * 1e3, 1) for w in walls]} ms); top: {top}  "
              f"[{stamp}]", flush=True)
    finally:
        shutil.rmtree(rep["ckpt_dir"], ignore_errors=True)
        for t in (tr, tr2):
            for slot in t.slots:
                slot.pipe.shutdown()

    # 5. the unfused path: each partition's plane fetch launches cache_gather
    unfused = [a for a in MULTIPART_ARGS if a != "--fused-gather-agg"]
    unfused[unfused.index("--steps") + 1] = "4"
    urep, ulaunch, uwall = _run_multipart(torch, unfused, stamp)
    utr = urep["trainer"]
    try:
        dispatches = sum(s.pipe.plane.gather_dispatches for s in utr.slots)
        inputs = [s.halo_stats.inputs for s in utr.slots]
        uwant = {"cache_gather": dispatches, "gather_aggregate": 0,
                 "neighbor_agg": 0, "neighbor_agg_backward": 0,
                 "flash_attention": 0, "reservoir_topm": 0}
        print(f"[multipart] unfused, {urep['report'].steps_run} global "
              f"steps: launches {ulaunch} (expected {uwant}: one "
              f"cache_gather per {4096}-row chunk of each plane fetch, "
              f"{inputs} input rows per partition); run_gnn {uwall:.2f} s  "
              f"[{stamp}]", flush=True)
        if not (urep["report"].steps_run == 4 and ulaunch == uwant
                and dispatches >= 2 * 4):
            fail(f"unfused multi-partition launches {ulaunch}, expected "
                 f"{uwant}")
    finally:
        shutil.rmtree(urep["ckpt_dir"], ignore_errors=True)
        for t in (utr, urep["restored"]):
            for slot in t.slots:
                slot.pipe.shutdown()
    return {"fused": launches, "unfused": ulaunch}


@contextlib.contextmanager
def _timed(torch, cls, names, log: list):
    """Wrap each method ``names`` of ``cls`` so that a call appends (name,
    host seconds up to a synchronised card, the instance, the arguments) to
    ``log``; the methods are restored on exit."""
    saved = {n: cls.__dict__[n] for n in names}

    def wrap(name, fn):
        def timed(self, *a, **k):
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            log.append((name, time.perf_counter() - t0, self, a))
            return out
        return timed
    for n, fn in saved.items():
        setattr(cls, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


def _clone(torch, tree):
    """A copy of a trainer's ``state_dict()`` whose tensors are new."""
    from repro_torch.models.params import tree_map
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def _state_equal(torch, tr, state) -> bool:
    from repro_torch.models.params import leaves
    mine, want = leaves(tr.state_dict()), leaves(state)
    return len(mine) == len(want) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(mine, want))


def phase_autotune(torch, stamp: str) -> dict:
    """The online auto-tuner at full width (phase 10): (a) the CLI path,
    (b) a scripted plane flip, restarts and a halo swap on one controller.
    Returns the launch counts of (a)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.gnn import AutotuneConfig
    from repro_torch.core.a3gnn import A3GNNTrainer
    from repro_torch.core.autotune.controller import (AutotuneController,
                                                      episode_space)
    from repro_torch.core.autotune.ppo import PPOAgent, PPOConfig
    from repro_torch.core.feature_plane import (DeviceFeaturePlane,
                                                HostFeaturePlane)
    from repro_torch.core.multipart import MultiPartitionTrainer
    from repro_torch.core.sampling import NeighborSampler, seed_loader
    from repro_torch.graph.batch import generate_batch
    from repro_torch.launch.train import build_parser, run_gnn
    from repro_torch.models.params import leaves
    from repro_torch.train.checkpoint import TrainerCheckpointMixin

    # (a) the CLI path, every controller phase timed on the host
    args = build_parser().parse_args(AUTOTUNE_ARGS)
    log: list = []
    buf = io.StringIO()
    with _timed(torch, AutotuneController,
                ("propose", "_apply_config", "measure"), log):
        counts = _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = run_gnn(args)
        torch.cuda.synchronize()
        launches = counts()
        wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"{line}  [{stamp}]", flush=True)
    rep, tr = out["report"], out["trainer"]
    ctrl = log[-1][2]
    # warm-up (AutotuneConfig.warmup_steps, seq) and every episode's steps
    # are fused steps: 1 gather_aggregate, (layers - 1) neighbor_agg
    # forwards and as many backwards each; evaluate() runs the unfused
    # forward (plain torch) and fused_inputs no cache_gather
    steps = AutotuneConfig().warmup_steps + AUTOTUNE_EPISODES * AUTOTUNE_STEPS
    hops = tr.cfg.num_layers - 1
    want = {"cache_gather": 0, "gather_aggregate": steps,
            "neighbor_agg": hops * steps, "neighbor_agg_backward": hops * steps,
            "flash_attention": 0, "reservoir_topm": 0}
    print(f"[autotune] {ARCH} fused, full width: {len(rep.episodes)} "
          f"episodes x {AUTOTUNE_STEPS} steps after {ctrl.acfg.warmup_steps} "
          f"warm-up steps; launches {launches} (expected {want}); run_gnn "
          f"incl. the trainer build {wall:.2f} s  [{stamp}]", flush=True)
    if launches != want:
        fail(f"autotune launches {launches}, expected {want}")
    if [ep.steps for ep in rep.episodes] != [AUTOTUNE_STEPS] * \
            AUTOTUNE_EPISODES:
        fail(f"autotune episodes ran {[ep.steps for ep in rep.episodes]} "
             f"steps")
    pending = {"propose": 0.0, "_apply_config": 0.0}
    for name, secs, _, a in log:
        if name != "measure":
            pending[name] += secs
            continue
        ep = rep.episodes[a[0]]
        m, pred = ep.metrics, ep.predicted
        print(f"[autotune] episode {ep.index}: config {ep.config}; measured "
              f"throughput {m['throughput']} steps/s, memory {m['memory']} B, "
              f"accuracy {m['accuracy']}; hit rate {ep.cache_hit_rate}; "
              f"surrogate predicted {pred}; host seconds: propose "
              f"{pending['propose']}, reconfigure {pending['_apply_config']}, "
              f"measure {secs}  [{stamp}]", flush=True)
        if not all(map(math.isfinite, m.values())):
            fail(f"episode {ep.index}: metrics {m}")
        pending = {"propose": 0.0, "_apply_config": 0.0}
    print(f"[autotune] best episode {rep.best.index} (feasible "
          f"{rep.best_feasible}); reconfigure to it {pending['_apply_config']}"
          f" s; trainer left on {tr.cfg.parallel_mode}, workers "
          f"{tr.cfg.workers}, Θ {tr.cfg.cache_volume_mb} MB  [{stamp}]",
          flush=True)
    agent = ctrl.agent
    on_card = all(p.is_cuda for p in agent.parameters())
    if not (on_card and all(p.is_cuda for p in leaves(tr.params))):
        fail("the PPO agent or the trainer is not on cuda")

    # one PPO update on the card against the same update on the CPU, from
    # one seed and one rollout against the run's surrogate
    def agent_on(dev):
        return PPOAgent(episode_space(ctrl.acfg), ctrl._surrogate_eval,
                        agent.w, ctrl.feasible,
                        PPOConfig(horizon=ctrl.acfg.ppo_horizon, seed=0),
                        device=dev)
    host, card = agent_on("cpu"), agent_on("cuda")
    same_init = all(torch.equal(x.cpu(), y) for x, y in
                    zip(card.parameters(), host.parameters()))
    s, a, logp, r, v = host._rollout(
        np.random.default_rng(0).random(host.space.dim))
    adv, ret = host._gae(r, v)
    for ag in (host, card):
        ag._update((s, a, logp, ret, adv))
    ppo_err = max(float((x.detach().cpu() - y.detach()).abs().max())
                  for x, y in zip(card.parameters(), host.parameters()))
    n_ppo = sum(p.numel() for p in agent.parameters())
    print(f"[check] PPO agent on {agent.device} ({n_ppo} parameters); one "
          f"update on the card vs the "
          f"CPU from one seed (initial weights equal={same_init}): max abs "
          f"diff {ppo_err:.2e} (tolerance 1e-5)", flush=True)
    if not (same_init and ppo_err <= 1e-5):
        fail("the PPO update on the card differs from the CPU")

    # (b) a scripted run on one controller at full width
    cfg = get_config(ARCH).replace(sampling_device="device",
                                   fused_gather_agg=True)
    tb = A3GNNTrainer(tr.full_graph, cfg, seed=0, device="cuda")
    restart_dir = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    ctrl = AutotuneController(tb, tb.make_pipeline(), AutotuneConfig(
        steps_per_episode=4, warmup_steps=0, tune_sampling_device=True,
        max_partitions=2, max_halo_budget=4096, restart_dir=restart_dir,
        seed=0))
    try:
        # 1. device -> cpu -> device planes over one cache: one fused step
        # from one state and batch, the table path against the sideband
        seeds = next(iter(seed_loader(tb.graph, cfg.batch_size, 0)))
        mb = generate_batch(NeighborSampler(tb.graph, cfg.fanout,
                                            weight_fn=tb.weight_fn,
                                            seed=0).sample(seeds),
                            ctrl.pipe.plane, tb.graph, fused=True)
        if mb.features is not None:
            fail("the fused batch carries features")
        state = _clone(torch, tb.state_dict())
        flips = []
        counts = _zero_counts()
        for dev, kind in (("device", DeviceFeaturePlane),
                          ("cpu", HostFeaturePlane),
                          ("device", DeviceFeaturePlane)):
            t0 = time.perf_counter()
            ctrl._apply_config({"sampling_device": dev})
            t_swap = time.perf_counter() - t0
            plane = ctrl.pipe.plane
            if not (isinstance(plane, kind) and plane.cache is tb.cache):
                fail(f"sampling_device={dev}: plane {plane}")
            tb.load_state_dict(_clone(torch, state))
            loss, _ = tb._train_fn(mb, plane)
            flips.append((dev, loss, t_swap, [p.clone() for p in
                                              leaves(tb.params)]))
        torch.cuda.synchronize()
        fl = counts()
        same = all(f[1] == flips[0][1] and all(
            torch.equal(x, y) for x, y in zip(f[3], flips[0][3]))
            for f in flips)
        print(f"[check] plane flip device -> cpu -> device, one cache, "
              f"{len(mb.input_ids)} input ids: fused-step losses "
              f"{[f[1] for f in flips]}, updated params bit-equal={same}; "
              f"swap host seconds {[round(f[2], 6) for f in flips]}; "
              f"launches {fl}  [{stamp}]", flush=True)
        if not (same and fl["gather_aggregate"] == 3):
            fail("the fused step differs between the device and cpu planes")
        tb.load_state_dict(state)

        # 2. restart to 2 partitions with a 4096-row halo budget
        tlog: list = []
        before = _clone(torch, tb.state_dict())
        with _timed(torch, TrainerCheckpointMixin, ("save", "restore"),
                    tlog):
            t0 = time.perf_counter()
            ctrl._apply_config({"partitions": 2, "halo_budget": 4096})
            t_restart = time.perf_counter() - t0
        mp = ctrl.tr
        secs = {name: t for name, t, _, _ in tlog}
        carried = _state_equal(torch, mp, before)
        print(f"[autotune] restart 1 -> 2 partitions, halo budget 4096: "
              f"{t_restart} s host, of which checkpoint write {secs['save']}"
              f", planning {mp.plan_seconds}, restore {secs['restore']}; "
              f"params and opt_state torch.equal={carried}  [{stamp}]",
              flush=True)
        if not (isinstance(mp, MultiPartitionTrainer) and mp.plan.parts == 2
                and mp.plan.halo_budget == 4096 and carried
                and mp.device.type == "cuda" and ctrl.restarts == 1):
            fail("the restart to 2 partitions did not carry the state over")
        counts = _zero_counts()
        ep = ctrl.measure(1, ctrl._current_config())
        torch.cuda.synchronize()
        got = counts()
        ewant = {"cache_gather": 0, "gather_aggregate": 8,
                 "neighbor_agg": 8 * hops, "neighbor_agg_backward": 8 * hops,
                 "flash_attention": 0, "reservoir_topm": 0}
        print(f"[autotune] episode at 2 partitions, 4 global steps: "
              f"{ep.steps} partition steps, metrics {ep.metrics}, hit rate "
              f"{ep.cache_hit_rate}, halo hit rate {mp.halo_hit_rate}; "
              f"launches {got} (expected {ewant})  [{stamp}]", flush=True)
        if not (ep.steps == 8 and got == ewant
                and all(map(math.isfinite, ep.metrics.values()))):
            fail(f"the 2-partition episode: {ep.steps} steps, {got}")

        # 3. the halo budget swapped live to 0: no restart
        before = _clone(torch, mp.state_dict())
        t0 = time.perf_counter()
        ctrl._apply_config({"halo_budget": 0})
        t_halo = time.perf_counter() - t0
        ok = (ctrl.tr is mp and mp.plan.halo_budget == 0
              and ctrl.restarts == 1 and _state_equal(torch, mp, before))
        print(f"[autotune] halo budget 4096 -> 0 live: {t_halo} s host, the "
              f"same trainer, state carried={ok}  [{stamp}]", flush=True)
        if not ok:
            fail("the live halo swap rebuilt the trainer or lost its state")

        # 4. restart back to 1 partition
        before = _clone(torch, mp.state_dict())
        t0 = time.perf_counter()
        ctrl._apply_config({"partitions": 1})
        t_back = time.perf_counter() - t0
        back = ctrl.tr
        carried = _state_equal(torch, back, before)
        counts = _zero_counts()
        one = ctrl.pipe.run(max_steps=1)
        torch.cuda.synchronize()
        got = counts()
        print(f"[autotune] restart 2 -> 1 partition: {t_back} s host; params "
              f"and opt_state torch.equal={carried}; one step after: loss "
              f"{one.losses}, launches {got}  [{stamp}]", flush=True)
        if not (isinstance(back, A3GNNTrainer) and carried
                and ctrl.restarts == 2 and back.device.type == "cuda"
                and got["gather_aggregate"] == 1
                and all(map(math.isfinite, one.losses))):
            fail("the restart back to 1 partition did not carry the state")
    finally:
        ctrl.pipe.shutdown()
        shutil.rmtree(restart_dir, ignore_errors=True)
    return launches


FABRIC_PARTS = ("train", "warm", "load", "refresh", "burst")


@contextlib.contextmanager
def _fabric_probe(watch_rid: int):
    """Wrap ``ServingFabric.step`` and the four stages of an engine step
    (``NeighborSampler.sample``, the plane fetch in ``generate_batch``, the
    padding in ``inference_arrays``, ``GNNInferenceEngine._fwd``), so that
    each fabric step appends its wall seconds, the host seconds of each
    stage summed over the engines it stepped, and their count to ``steps``.
    The fetch and the forward each end in a copy to the host, so the card's
    work is inside the stage that issued it; ``t0`` is the step's start.
    A forward whose engine holds request ``watch_rid`` appends (engine,
    params, features, index arrays, logits, the request's row) to
    ``seen``.  Restored on exit."""
    from repro_torch.core.sampling import NeighborSampler
    from repro_torch.serve import gnn_engine
    from repro_torch.serve.fabric import ServingFabric
    steps, seen, cur = [], [], {}
    saved = [(NeighborSampler, "sample"), (gnn_engine, "generate_batch"),
             (gnn_engine, "inference_arrays"),
             (gnn_engine.GNNInferenceEngine, "_fwd"), (ServingFabric, "step")]
    orig = [getattr(owner, name) for owner, name in saved]

    def timed(stage, fn):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            cur[stage] = cur.get(stage, 0.0) + time.perf_counter() - t0
            return out
        return wrap

    fwd = timed("forward", orig[3])

    def forward(self, params, feats, idxs):
        out = fwd(self, params, feats, idxs)
        cur["engines"] = cur.get("engines", 0) + 1
        rids = [self.running[s].rid for s in sorted(self.running)]
        if watch_rid in rids:
            seen.append((self, params, feats.copy(),
                         [i.copy() for i in idxs], out.copy(),
                         rids.index(watch_rid)))
        return out

    def step(self):
        cur.clear()
        t0 = time.perf_counter()
        n = orig[4](self)
        steps.append({"t0": t0, "wall": time.perf_counter() - t0, **cur})
        return n

    for (owner, name), fn in zip(saved, (
            timed("sample", orig[0]), timed("fetch", orig[1]),
            timed("pad", orig[2]), forward, step)):
        setattr(owner, name, fn)
    try:
        yield steps, seen
    finally:
        for (owner, name), fn in zip(saved, orig):
            setattr(owner, name, fn)


def phase_fabric(torch, stamp: str) -> dict:
    """The partition-routed serving fabric at full width (phase 11); returns
    the ``cache_gather`` launches of each part of (a) and of the chaos run,
    and every kernel's launches over (a)."""
    import numpy as np

    from repro_torch.launch.serve import build_parser, run_gnn_serve
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.serve.fabric import ServingFabric
    from repro_torch.serve.gnn_engine import GNNInferenceEngine, GNNRequest
    from repro_torch.serve.transport import (FaultSpec, VirtualClock,
                                             sim_host_factory)

    # (a) the CLI path
    args = build_parser().parse_args(FABRIC_ARGS)
    buf = io.StringIO()
    counts = _zero_counts()
    t0 = time.perf_counter()
    with _fabric_probe(args.queries) as (steps, seen), \
            contextlib.redirect_stdout(buf):
        rep = run_gnn_serve(args)
    torch.cuda.synchronize()
    total = counts()
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"{line}  [{stamp}]", flush=True)
    tr, fab = rep["trainer"], rep["fabric"]
    plan, cfg, parts = tr.plan, tr.cfg, tr.plan.parts
    launches, chunks = rep["launches"], rep["dispatches"]
    print(f"[fabric] plan: sizes {[len(ns) for ns in plan.node_sets]}, edge "
          f"locality {plan.edge_locality(tr.full_graph)}, halo rows "
          f"{plan.halo_rows}; planning {tr.plan_seconds} s host; "
          f"{parts}×{fab.replicas} replicas, batch {fab.engine_batch}; "
          f"launches of the whole run {total}; per part: cache_gather "
          f"{launches}, gather chunks the planes issued {chunks}, host "
          f"seconds {rep['seconds']}; run_gnn_serve {wall:.2f} s  "
          f"[{stamp}]", flush=True)
    others = {k: v for k, v in total.items() if k != "cache_gather"}
    if any(others.values()):
        fail(f"the fabric run launched other kernels: {others}")
    if sum(launches.values()) != total["cache_gather"]:
        fail(f"cache_gather launches by part {launches} do not sum to the "
             f"run's {total['cache_gather']}")
    for name in FABRIC_PARTS:
        if not (launches[name] == chunks[name] > 0):
            fail(f"{name}: cache_gather launches {launches[name]}, gather "
                 f"chunks {chunks[name]}")
    engines = fab.all_engines
    if not (all(e.device.type == "cuda" for e in engines)
            and all(p.is_cuda for p in leaves(tr.params))
            and all(part[0].plane.device.type == "cuda"
                    and all(e.plane is part[0].plane for e in part)
                    for part in fab.engines)):
        fail("a replica, its plane or the parameters are not on cuda")

    # the load: whole, finite, routed to the owner, conserved
    served, nodes, ncls = rep["served"], rep["nodes"], cfg.num_classes
    owners = plan.owner_of(nodes)
    if not (len(served) == args.queries
            and all(r.status == "done" for r in served)
            and all(r.logits.shape == (ncls,)
                    and bool(np.isfinite(r.logits).all()) for r in served)):
        fail(f"{sum(r.status == 'done' for r in served)}/{args.queries} "
             f"queries done with finite logits")
    if not (all(r.partition == owners[r.rid]
                and 0 <= r.replica < fab.replicas for r in served)
            and rep["per_partition"] == np.bincount(
                owners, minlength=parts).tolist()):
        fail(f"routing: per partition {rep['per_partition']}, owners "
             f"{np.bincount(owners, minlength=parts).tolist()}")
    # the replicas' warm-up requests were stepped on the engines directly,
    # never offered to the fabric: they retire in ``done`` alone
    audit, warm_served = fab.audit(), rep["warm_served"]
    if not (audit["pending"] == audit["inflight"] == 0
            and audit["offered"] + warm_served
            == audit["done"] + audit["shed"] + audit["timed_out"]):
        fail(f"audit does not balance: {audit}, {warm_served} warm-up "
             f"requests")
    per_replica = {f"{p}/{r}": st.completed for (p, r), st in
                   sorted(fab.replica_state.items())}
    s = rep["stats"]
    load_steps = steps[:s["fabric_steps"]]
    # a replica's engine re-stamps ``t_submit`` when the request reaches
    # it, so the fabric's percentiles run from dispatch; the whole load was
    # queued before its first fabric step, which bounds the queue wait
    e2e = np.array([r.t_done - load_steps[0]["t0"] for r in served]) * 1e3
    print(f"[fabric] load: {s['completed']} queries at "
          f"{s['queries_per_s']} q/s, p50 {s['p50_ms']} ms, p99 "
          f"{s['p99_ms']} ms from dispatch; from the first fabric step p50 "
          f"{float(np.percentile(e2e, 50))} ms, p99 "
          f"{float(np.percentile(e2e, 99))} ms; {s['fabric_steps']} fabric "
          f"steps; per "
          f"partition {rep['per_partition']}; per replica over the run "
          f"{per_replica}; audit {audit} ({warm_served} warm-up requests "
          f"in done)  [{stamp}]", flush=True)
    full = [st for st in load_steps if st.get("engines") == len(engines)]
    pick = full or load_steps
    split = ", ".join(
        f"{k} {float(np.mean([st.get(k, 0.0) for st in pick])) * 1e3:.3f}"
        for k in ("sample", "fetch", "pad", "forward"))
    print(f"[breakdown] fabric step of the load (mean of {len(pick)} steps "
          f"with {'every' if full else 'any'} replica busy): wall "
          f"{float(np.mean([st['wall'] for st in pick])) * 1e3:.3f} ms = "
          f"its engines' steps, summed: {split} ms; engines stepped "
          f"{[st.get('engines', 0) for st in load_steps]}; fabric-step "
          f"walls {[round(st['wall'] * 1e3, 2) for st in load_steps]} ms  "
          f"[{stamp}]", flush=True)

    # the refresh: stale until the hand-off, then the trainer's new tree
    rq, warm = rep["requery"], rep["warm_params"]
    if not (all(h is warm for h in rep["held_before_refresh"])
            and warm is not tr.params
            and all(e.params is tr.params for e in engines)):
        fail("before refresh_weights every replica must hold the warm tree, "
             "after it the trainer's")
    if not (rq.rid == args.queries and rq.status == "done"
            and len(seen) == 1 and seen[0][1] is tr.params):
        fail(f"the re-query: {rq.status}, {len(seen)} forwards seen")
    eng, _, feats, idxs, logits, row = seen[0]
    fresh = GNNInferenceEngine(eng.graph, cfg, tr.params, plane=eng.plane,
                               batch=eng.batch, node_map=eng.node_map,
                               device=eng.device)
    again = fresh._fwd(tr.params, feats, idxs)[row]
    stale = fresh._fwd(warm, feats, idxs)[row]
    print(f"[check] re-query rid {rq.rid} on replica "
          f"{rq.partition}/{rq.replica}: logits bit-equal to a fresh "
          f"engine's forward with the trainer's new tree on the same batch="
          f"{bool(np.array_equal(again, rq.logits))} (and to the probe's "
          f"{bool(np.array_equal(logits[row], rq.logits))}); the warm tree "
          f"on that batch differs by {float(abs(stale - rq.logits).max())}",
          flush=True)
    if not (np.array_equal(again, rq.logits)
            and np.array_equal(logits[row], rq.logits)
            and not np.array_equal(stale, rq.logits)):
        fail("the re-query is not the trainer's new tree on its batch")

    # the burst: explicit degradation
    b = rep["burst"]
    print(f"[fabric] burst: offered {b['offered']}, served {b['completed']}, "
          f"shed {b['shed']} (fraction {b['shed_fraction']}), deferrals "
          f"{b['deferrals']}, {b['fabric_steps']} fabric steps in "
          f"{b['seconds']} s at target {fab.slo.slo_p99_ms} ms; served p50 "
          f"{b['p50_ms']} ms p99 {b['p99_ms']} ms  [{stamp}]", flush=True)
    if not (b["shed"] > 0 and b["completed"] > 0):
        fail(f"the burst must shed and serve: {b}")

    # (b) chaos on the card: SimHost replicas on a virtual clock, one killed
    t0 = time.perf_counter()
    plan_h = plan.with_halo_budget(tr.full_graph, FABRIC_HALO)
    t_plan = time.perf_counter() - t0
    rng = np.random.default_rng(tr.seed)
    chaos_nodes = rng.choice(np.flatnonzero(tr.full_graph.test_mask),
                             CHAOS_QUERIES, replace=False)
    host_params = tree_map(lambda t: t.cpu(), tr.params)

    def chaos(device, params):
        fab_c = ServingFabric.from_plan(
            tr.full_graph, plan_h, cfg, params, batch=4, replicas=2, seed=0,
            transport_factory=sim_host_factory(
                faults={(0, 0): FaultSpec(added_latency_ms=2,
                                          down_after_responses=3)},
                base=FaultSpec(added_latency_ms=2), seed=0),
            clock=VirtualClock(tick_s=1e-3), timeout_ms=8,
            record_trace=True, device=device)
        d0 = sum(p[0].plane.gather_dispatches for p in fab_c.engines)
        counts = _zero_counts()
        t0 = time.perf_counter()
        for i in range(0, len(chaos_nodes), 4):
            for rid in range(i, min(i + 4, len(chaos_nodes))):
                fab_c.submit(GNNRequest(rid=rid, node=int(chaos_nodes[rid])))
            fab_c.step()
        fab_c.drain()
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (fab_c, counts(), secs,
                sum(p[0].plane.gather_dispatches for p in fab_c.engines) - d0)

    runs = [chaos("cuda", tr.params), chaos("cuda", tr.params),
            chaos("cpu", host_params)]
    (c1, l1, s1, d1), (c2, l2, _, _), (c3, _, s3, _) = runs
    a1 = c1.audit()
    st00 = c1.replica_state[(0, 0)]
    done = [{r.rid: r for r in c.completed} for c, _, _, _ in runs]
    logits_eq = done[0].keys() == done[1].keys() and all(
        np.array_equal(r.logits, done[1][k].logits)
        for k, r in done[0].items())
    host_trace = [e[:4] for e in c3.request_trace]
    cpu_diff = max((float(abs(r.logits - done[2][k].logits).max())
                    for k, r in done[0].items()), default=0.0)
    preds_eq = all(r.pred == done[2][k].pred for k, r in done[0].items())
    print(f"[chaos] {CHAOS_QUERIES} queries 4 a step over SimHost replicas "
          f"on a virtual clock (2 ms a response, timeout 8 ms, replica 0/0 "
          f"killed after its 3rd response), halo budget {FABRIC_HALO} "
          f"(re-budgeted in {t_plan:.3f} s): audit {a1}; {c1.fstats.asdict()}"
          f"; 0/0 {st00.state}, timeouts {st00.timeouts}; launches {l1} "
          f"(gather chunks {d1}); {s1:.3f} s on the card, {s3:.3f} s on the "
          f"CPU  [{stamp}]", flush=True)
    print(f"[check] chaos: trace identical run to run="
          f"{c1.request_trace == c2.request_trace}, logits bit-equal="
          f"{logits_eq}; card vs CPU: (rid, partition, replica, status) "
          f"identical={[e[:4] for e in c1.request_trace] == host_trace}, "
          f"preds equal={preds_eq}, logits max_abs_diff={cpu_diff} "
          f"(tolerance 1e-4)", flush=True)
    if not (a1["pending"] == a1["inflight"] == 0 and a1["offered"]
            == a1["done"] + a1["shed"] + a1["timed_out"] == CHAOS_QUERIES):
        fail(f"chaos audit does not balance: {a1}")
    if not (st00.state == "down" and c1.fstats.timeouts > 0
            and c1.fstats.retries > 0):
        fail(f"chaos: replica 0/0 {st00.state}, {c1.fstats.asdict()}")
    if not (c1.request_trace == c2.request_trace and logits_eq
            and len(c1.request_trace) == CHAOS_QUERIES):
        fail("chaos: two runs on the card differ")
    if not ([e[:4] for e in c1.request_trace] == host_trace and preds_eq
            and cpu_diff <= 1e-4):
        fail("chaos: the card and the CPU differ")
    if not (l1["cache_gather"] == d1 > 0
            and sum(l1.values()) == l1["cache_gather"]):
        fail(f"chaos launches {l1}, gather chunks {d1}")

    # the halo rows in each card plane equal the owner's
    owner_local = plan_h.local_ids()
    halo_ok = []
    for p, (ns, hs) in enumerate(zip(plan_h.node_sets, plan_h.halo_sets)):
        plane = c1.engines[p][0].plane
        local = np.arange(len(ns), len(ns) + len(hs))
        resident = int(plane.cache.is_cached(local).sum())
        want = np.stack([plan_h.subgraphs[q].features[owner_local[v]]
                         for q, v in zip(plan_h.owner[hs], hs)])
        slots = torch.from_numpy(plane.cache.device_map[local]).long()
        table = plane._dev_table[slots.to(plane.device)].cpu().numpy()
        halo_ok.append((len(hs), resident,
                        bool(np.array_equal(plane.fetch(local), want)),
                        bool(np.array_equal(table, want))))
    print(f"[check] chaos fabric halo rows (rows, resident on the card, "
          f"fetched bit-equal to the owner's, card table bit-equal) per "
          f"partition: {halo_ok}", flush=True)
    if not all(n == res > 0 and ok and tab for n, res, ok, tab in halo_ok):
        fail(f"halo rows in the fabric's device planes: {halo_ok}")
    for slot in tr.slots:
        slot.pipe.shutdown()
    return {"parts": launches, "chaos": l1["cache_gather"], "total": total}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", default=None, nargs="+",
                    metavar="PATH",
                    help="the parent commit's csrc/segment_agg.cu, "
                         "csrc/fused_gather_agg.cu and csrc/reservoir.cu, "
                         "or a directory that holds them (or its checkout "
                         "root), where this checkout has no git history")
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
    parent = parent_kernels(torch, args.parent_source)
    entries = [entry] + phase_agg(torch, stamp, train["batch"],
                                  train["launches"], parent)
    flash = phase_flash(torch, stamp)
    lm = phase_lm(torch, stamp)
    reservoir = phase_reservoir(torch, stamp, train, parent)
    flash["launches"] = lm["prefill"]["flash_attention"]
    flash["decode_launches"] = lm["serve"]["flash_attention"]
    reservoir["path_launches"] = {
        "gnn_serve": launches["reservoir_topm"],
        "train": train["launches"]["reservoir_topm"],
        "lm_prefill": lm["prefill"]["reservoir_topm"],
        "lm_serve": lm["serve"]["reservoir_topm"]}
    multipart = phase_multipart(torch, stamp)
    entry["multipart_unfused_launches"] = multipart["unfused"]["cache_gather"]
    entries[1]["multipart_launches"] = multipart["fused"]["gather_aggregate"]
    entries[2]["multipart_launches"] = multipart["fused"]["neighbor_agg"]
    entries[2]["multipart_backward_launches"] = \
        multipart["fused"]["neighbor_agg_backward"]
    reservoir["path_launches"]["multipart"] = \
        multipart["fused"]["reservoir_topm"]
    autotune = phase_autotune(torch, stamp)
    entry["autotune_launches"] = autotune["cache_gather"]
    entries[1]["autotune_launches"] = autotune["gather_aggregate"]
    entries[2]["autotune_launches"] = autotune["neighbor_agg"]
    entries[2]["autotune_backward_launches"] = \
        autotune["neighbor_agg_backward"]
    reservoir["path_launches"]["autotune"] = autotune["reservoir_topm"]
    fabric = phase_fabric(torch, stamp)
    entry["fabric_launches"] = sum(n for k, n in fabric["parts"].items()
                                   if k != "train")
    entry["fabric_warmup_train_launches"] = fabric["parts"]["train"]
    entry["fabric_chaos_launches"] = fabric["chaos"]
    reservoir["path_launches"]["fabric"] = fabric["total"]["reservoir_topm"]
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
