#!/usr/bin/env python3
"""The bulk-copy route of the two GNN forwards, timed against the port's
kernels on one CUDA card.

  python3 scripts/fwd_bulk_route.py

Builds ``scripts/fwd_bulk_route.cu`` (TMA's 1-D bulk copy of every row a
tile needs into shared memory, counted by an mbarrier) with the port's
``nvcc`` flags, makes the first full-width graphsage-products training
batch as ``chip_smoke.py``'s phase 4 does (seed 0), and at
``gather_aggregate``'s layer 0 (mean) and the ``neighbor_agg`` forward at
hops 1 and 2 (mean) and GAT's layer 0 (weighted): holds the route's outputs
bit-equal to the kernel's, then times kernel / route / route / kernel with
``chip_smoke.py``'s harness (median of 50 calls, L2 flushed before each).
Each route is timed at the block size it was fastest with (128 threads for
``neighbor_agg``, 256 for ``gather_aggregate``).  Exits non-zero without a
CUDA card or on a mismatch.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().with_suffix(".cu")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[fail] no CUDA device: this script times kernels on a GPU",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.a3gnn import A3GNNTrainer
    from repro_torch.core.feature_plane import DeviceFeaturePlane
    from repro_torch.core.sampling import NeighborSampler, seed_loader
    from repro_torch.graph.batch import batch_device_arrays, compute_level_caps
    from repro_torch.graph.synthetic import dataset_like
    from repro_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, _nvcc
    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.kernels.segment_agg.ops import neighbor_agg

    lib_path = BUILD_DIR / "libfwd_bulk_route.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(SOURCE)],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    seg = lib.neighbor_agg_fwd_bulk_launch
    seg.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                    + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])
    ga = lib.gather_aggregate_bulk_launch
    ga.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    seg.restype = ga.restype = ctypes.c_int

    # the first full-width training batch, as chip_smoke.py's phase 4 makes it
    cfg = get_config("graphsage-products").replace(
        sampling_device="device", fused_gather_agg=True)
    g = dataset_like(cfg, seed=0)
    tr = A3GNNTrainer(g, cfg, seed=0, device="cuda")
    sampler = NeighborSampler(tr.graph, cfg.fanout, weight_fn=tr.weight_fn,
                              seed=0)
    seeds = next(iter(seed_loader(tr.graph, cfg.batch_size, 0)))
    mb = sampler.sample(seeds)
    caps = compute_level_caps(len(seeds), cfg.fanout, tr.graph.num_nodes)
    arrays = batch_device_arrays(mb, level_caps=caps)
    plane = DeviceFeaturePlane(tr.graph, tr.cache, device="cuda")
    enc, aux, table = plane.fused_inputs(mb.input_ids, arrays["pads"][0])
    idxs = [torch.from_numpy(i).cuda() for i in arrays["neigh_idxs"]]

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    stamp = cs.card_stamp()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def ga_route(mode):
        (nd, fan), (c, f) = idxs[0].shape, table.shape
        h_dst = torch.empty((nd, f), device=dev)
        agg = torch.empty((nd, f), device=dev)
        err = ga(enc.data_ptr(), idxs[0].data_ptr(), table.data_ptr(),
                 aux.data_ptr(), h_dst.data_ptr(), agg.data_ptr(),
                 enc.shape[0], nd, fan, c, aux.shape[0], f,
                 {"mean": 0, "sum": 1}[mode], 256, stream())
        if err:
            raise SystemExit(f"[fail] the bulk gather_aggregate: error {err}")
        return h_dst, agg

    def seg_route(idx, h, mode, w):
        (nd, fan), (ns, d) = idx.shape, h.shape
        out = torch.empty((nd, d), device=dev)
        err = seg(idx.data_ptr(), h.data_ptr(),
                  None if w is None else w.data_ptr(), out.data_ptr(), nd, fan,
                  ns, d, 2 if w is not None else {"mean": 0, "sum": 1}[mode],
                  128, stream())
        if err:
            raise SystemExit(f"[fail] the bulk neighbor_agg forward: error {err}")
        return out

    def report(label, kernel, route, same):
        t = [cs.time_ms(torch, fn, flush) for fn in (kernel, route, route,
                                                     kernel)]
        print(f"[route] {label}: outputs bit-equal={same}; turns kernel / "
              f"bulk-copy route / bulk-copy route / kernel {t} ms  [{stamp}]",
              flush=True)
        return same

    ok = True
    want = gather_aggregate(enc, idxs[0], table, aux)
    got = ga_route("mean")
    torch.cuda.synchronize()
    ok &= report(f"gather_aggregate layer 0 mean idx {tuple(idxs[0].shape)} "
                 f"F={table.shape[1]}",
                 lambda: gather_aggregate(enc, idxs[0], table, aux),
                 lambda: ga_route("mean"),
                 torch.equal(want[0], got[0]) and torch.equal(want[1], got[1]))
    for label, idx, ns, mode in (("hop1", idxs[1], idxs[0].shape[0], "mean"),
                                 ("hop2", idxs[2], idxs[1].shape[0], "mean"),
                                 ("gat_layer0", idxs[0], enc.shape[0],
                                  "weighted")):
        h = torch.randn((ns, 256), generator=gen, device=dev)
        w = (torch.rand(idx.shape, generator=gen, device=dev)
             if mode == "weighted" else None)
        m = "sum" if w is not None else mode
        want = neighbor_agg(idx, h, m, w)
        got = seg_route(idx, h, m, w)
        torch.cuda.synchronize()
        ok &= report(f"neighbor_agg forward {label} {mode} idx "
                     f"{tuple(idx.shape)} D=256",
                     lambda: neighbor_agg(idx, h, m, w),
                     lambda: seg_route(idx, h, m, w), torch.equal(want, got))
    if not ok:
        print("[fail] the bulk-copy route disagrees with the kernel",
              file=sys.stderr)
        return 1
    print(f"[card] {stamp}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
