"""Training entry point of the port: A³GNN end to end on a synthetic twin
dataset, with the configured sampling / caching / parallelism strategy,
reporting the paper's metrics:

  PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage-products \
      --sampling-device device --fused-gather-agg --steps 8

Everything runs on ``--device`` (default ``cuda``); ``--device cpu`` runs
the plain versions of the kernels on the host.  ``--fused-gather-agg``
takes the all-hop fused step (the ``gather_aggregate`` and
``neighbor_agg`` kernels, forward and backward).  The online auto-tuner
(``--autotune``), the multi-partition scale-out (``--partitions`` > 1) and
the LM workloads are not ported yet.
"""
from __future__ import annotations

import argparse
from typing import Dict

NOT_PORTED = "not ported yet — see ROADMAP.md"


def run_gnn(args) -> Dict:
    """Train ``args.steps`` steps per epoch and print the result and the
    stage split.  Returns the trainer and its ``RunResult``."""
    from repro_torch.configs import get_config
    from repro_torch.core.a3gnn import A3GNNTrainer, apply_baseline
    from repro_torch.graph.synthetic import dataset_like

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.mode:
        cfg = cfg.replace(parallel_mode=args.mode)
    if args.bias_rate is not None:
        cfg = cfg.replace(bias_rate=args.bias_rate)
    if args.sampling_device is not None:
        cfg = cfg.replace(sampling_device=args.sampling_device)
    if args.fused_gather_agg:
        cfg = cfg.replace(fused_gather_agg=True)
    cfg = apply_baseline(cfg, args.baseline)
    graph = dataset_like(cfg, seed=args.seed)
    print(f"[data] {graph.name}: {graph.num_nodes} nodes, "
          f"{graph.num_edges} edges")
    tr = A3GNNTrainer(graph, cfg, seed=args.seed, device=args.device)
    res = tr.run_epochs(args.epochs, max_steps_per_epoch=args.steps)
    print(f"[result] thr={res.throughput_epochs_s:.4f} ep/s "
          f"({res.throughput_steps_s:.2f} steps/s) "
          f"mem={res.memory_bytes/2**20:.1f} MiB "
          f"acc={res.test_acc:.4f} hit_rate={res.cache_hit_rate:.3f}")
    st = res.stats.stage_times()
    print(f"[stages] sample={st.t_sample*1e3:.1f}ms "
          f"batch={st.t_batch*1e3:.1f}ms train={st.t_train*1e3:.1f}ms")
    return {"trainer": tr, "result": res}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where parameters, the train step and a device "
                         "plane's cache table live")
    ap.add_argument("--baseline", default=None,
                    choices=[None, "a3gnn", "pyg_like", "quiver_like"])
    ap.add_argument("--mode", default=None,
                    choices=[None, "seq", "mode1", "mode2"])
    ap.add_argument("--bias-rate", type=float, default=None)
    ap.add_argument("--partitions", type=int, default=None,
                    help="data-parallel graph partitions (not ported yet)")
    ap.add_argument("--sampling-device", default=None,
                    choices=[None, "cpu", "device", "auto"],
                    help="feature-plane backend for batch generation: cpu "
                         "(numpy cache), device (cache table on --device), "
                         "auto (follows --device)")
    ap.add_argument("--fused-gather-agg", action="store_true",
                    help="all-hop fused step: batch generation defers feature "
                         "work to the train step, which resolves the input "
                         "hop from encoded cache slots + a miss sideband and "
                         "aggregates every hop in place")
    ap.add_argument("--autotune", action="store_true",
                    help="online auto-tuning controller (not ported yet)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.arch.startswith("graphsage"):
        raise SystemExit(f"LM training: {NOT_PORTED}")
    if args.partitions is not None and args.partitions > 1:
        raise SystemExit(f"--partitions > 1: {NOT_PORTED}")
    if args.autotune:
        raise SystemExit(f"--autotune: {NOT_PORTED}")
    run_gnn(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
