#!/usr/bin/env python3
"""Where the sharded step's gradient error comes from: each leaf's error
of the sharded bf16 step against the unsharded bf16 step (the reading
``chip_smoke.py``'s phase 19 (b) bounds), and of both against an f32
witness run from the same bf16 weights; for the Mamba2 blocks'
``in_proj``, ``conv_w`` and ``conv_b`` also each group of columns
(``in_proj``: z, x, B, C, dt; the conv: x, B, C).

    python3 scripts/sharded_grad_error.py [--arch zamba2-7b] \\
        [--seeds 13 29] [--smoke]

Runs phase 19 (b)'s run of ``--arch`` (``chip_smoke.SHARDED_RUNS``) with
each seed, as phase 19 runs it: 2 ``gloo-host`` ranks on one CUDA card,
a (1, 2) mesh.  ``--smoke`` runs the smoke config instead (2 layers,
2 x 64 tokens) as 2 ``gloo`` ranks on the CPU.  A leaf's error is
||g - g_ref|| / ||g_ref||.  Imports nothing of JAX.
"""
from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SSM_LEAVES = ("in_proj", "conv_w", "conv_b")


def column_groups(cfg, leaf: str) -> dict:
    """{group: (start, stop)} of a Mamba2 leaf's last dim."""
    from repro_torch.models.ssm import ssm_dims
    d_inner, nheads, N, _ = ssm_dims(cfg)
    edges = {"x": 0, "B": d_inner, "C": d_inner + N, "end": d_inner + 2 * N}
    if leaf == "in_proj":
        edges = {"z": 0, **{k: v + d_inner for k, v in edges.items()}}
        edges["dt"] = edges.pop("end")
        edges["end"] = edges["dt"] + nheads
    names = list(edges)
    return {a: (edges[a], edges[b]) for a, b in zip(names, names[1:])}


def errors(cfg, got: dict, want: dict) -> dict:
    """{leaf or "leaf[group]": ||got - want|| / ||want||}."""
    out = {}
    for k, w in want.items():
        g = got[k].float()
        w = w.float()
        parts = {"": (0, w.shape[-1])}
        if k.rsplit("/", 1)[-1] in SSM_LEAVES:
            parts.update(column_groups(cfg, k.rsplit("/", 1)[-1]))
        for name, (a, b) in parts.items():
            den = float(w[..., a:b].norm())
            num = float((g[..., a:b] - w[..., a:b]).norm())
            out[f"{k}[{name}]" if name else k] = num / den if den else 0.0
    return out


def error_rank(rank, device, spec):
    """A rank of the sharded step (``sharded_lm_rank``), its gradients
    held to the files ``spec["ref"]`` (the unsharded bf16 step's) and
    ``spec["witness"]`` (the f32 step's)."""
    import torch

    from repro_torch.launch.group import lm_config, sharded_lm_rank
    paths = {k: spec[k] for k in ("ref", "witness")}
    res = sharded_lm_rank(rank, device, {k: v for k, v in spec.items()
                                         if k not in paths})
    cfg = lm_config(spec)
    return {"loss": res["loss"],
            **{k: errors(cfg, res["grads"], torch.load(p)["grads"])
               for k, p in paths.items()}}


def main() -> int:
    import argparse

    import torch

    import chip_smoke as cs
    from repro_torch.launch.group import (HOST_STAGED, lm_config, lm_setup,
                                          sharded_lm_rank, spawn_partitions)
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.models.params import tree_map
    runs = {spec["arch"]: spec for spec in cs.SHARDED_RUNS}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-7b", choices=runs)
    ap.add_argument("--seeds", type=int, nargs="+", default=[13, 29])
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    if args.smoke:
        device, backend, stamp = "cpu", "gloo", "CPU"
        torch.set_num_threads(1)
    else:
        if not torch.cuda.is_available():
            print("[fail] no CUDA device (--smoke runs on the CPU)",
                  file=sys.stderr)
            return 1
        from repro_torch.kernels.build import build
        device, backend, stamp = "cuda:0", HOST_STAGED, cs.card_stamp()
        build(["flash_attention", "flash_attention_bwd"])
    print(f"[card] {stamp}; torch {torch.__version__}", flush=True)
    base = {**runs[args.arch], "steps": 1}
    if args.smoke:
        base.update(smoke=True, num_layers=2, seq=64)
    tmp = Path(tempfile.mkdtemp(prefix="sharded_grad_error_"))
    for seed in args.seeds:
        t0 = time.perf_counter()
        spec = {**base, "seed": seed}
        cfg = lm_config(spec)
        ref = sharded_lm_rank(0, device, spec)
        # the witness: the bf16 run's weights, exactly, in f32
        params = params_to_numpy(tree_map(
            lambda t: t.float(), lm_setup(spec, device)[2]))
        wit = sharded_lm_rank(0, device, {
            **{k: v for k, v in spec.items() if k != "init"},
            "params": params, "dtype": "float32"})
        del params
        torch.save({"grads": ref["grads"]}, tmp / "ref.pt")
        torch.save({"grads": wit["grads"]}, tmp / "witness.pt")
        unsharded = errors(cfg, ref["grads"], wit["grads"])
        del ref["grads"], wit["grads"]
        if device != "cpu":
            torch.cuda.empty_cache()
        ranks = spawn_partitions(
            error_rank, 2, backend, [device, device],
            args=({**spec, "ref": str(tmp / "ref.pt"),
                   "witness": str(tmp / "witness.pt")},), timeout=1200)
        worst = sorted(ranks[0]["ref"], key=lambda k: -ranks[0]["ref"][k])
        show = worst[:6] + [k for k in ranks[0]["ref"]
                            if "conv_w" in k and k not in worst[:6]]
        (tmp / "ref.pt").unlink()
        (tmp / "witness.pt").unlink()
        print(f"[grad-error] {args.arch} seed {seed}: loss bf16 "
              f"{ref['loss']:.6f}, f32 {wit['loss']:.6f}, rank 0 "
              f"{ranks[0]['loss']:.6f}; {time.perf_counter() - t0:.1f} s"
              f"  [{stamp}]", flush=True)
        print("[grad-error]   leaf: sharded vs unsharded bf16 (rank 0, "
              "rank 1); unsharded bf16 vs f32; sharded vs f32", flush=True)
        for k in show:
            print(f"[grad-error]   {k}: {ranks[0]['ref'][k]:.3e}, "
                  f"{ranks[1]['ref'][k]:.3e}; {unsharded[k]:.3e}; "
                  f"{ranks[0]['witness'][k]:.3e}", flush=True)
    tmp.rmdir()
    print(f"[card] {stamp}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
