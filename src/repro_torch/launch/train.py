"""Training entry point of the port: A³GNN end to end on a synthetic twin
dataset, with the configured sampling / caching / parallelism strategy,
reporting the paper's metrics:

  PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage-products \
      --sampling-device device --fused-gather-agg --steps 8

  PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage-products \
      --partitions 2 --halo-budget 4096 --sampling-device device \
      --fused-gather-agg --steps 8

Everything runs on ``--device`` (default ``cuda``); ``--device cpu`` runs
the plain versions of the kernels on the host.  ``--fused-gather-agg``
takes the all-hop fused step (the ``gather_aggregate`` and
``neighbor_agg`` kernels, forward and backward).  ``--partitions`` > 1
takes the multi-partition scale-out (``run_gnn_multipartition``): a
locality plan with a bounded halo, gradient-synchronised global steps
under the fault-tolerance supervisor with checkpoints, then a fresh
trainer that restores the committed checkpoint; every partition runs on
the one ``--device``.  ``--autotune`` trains the single-partition trainer
under the online auto-tuner (``fit_autotuned``: ``--episodes-autotune``
episodes of ``--steps`` steps each):

  PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage-products \
      --sampling-device device --fused-gather-agg --autotune \
      --episodes-autotune 4 --steps 10

The LM workloads are not ported yet.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Dict

NOT_PORTED = "not ported yet — see ROADMAP.md"


def run_gnn_multipartition(args, cfg, graph) -> Dict:
    """Scale-out GNN path: locality-partitioned data parallelism under the
    fault-tolerance supervisor, with a restart-path restore proof.  Returns
    the trainer, the supervisor's report, the restored trainer, the
    checkpoint directory and the host seconds of each part."""
    from repro_torch.core.a3gnn import make_trainer
    from repro_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    tr = make_trainer(graph, cfg, seed=args.seed, device=args.device)
    t_build = time.perf_counter() - t0
    plan = tr.plan
    print(f"[partition] {plan.parts} partitions ({plan.method}): "
          f"sizes={[len(ns) for ns in plan.node_sets]} "
          f"edge_locality={plan.edge_locality(graph):.3f} "
          f"halo={plan.halo_counts}")
    if plan.halo_budget > 0:
        print(f"[halo] budget={plan.halo_budget}/partition "
              f"kept={[len(hs) for hs in plan.halo_sets]} "
              f"kept_information={plan.kept_information(graph):.3f} "
              f"(vs {plan.edge_locality(graph):.3f} at budget=0) "
              f"exchange={tr.halo_exchange_bytes/2**10:.1f} KiB")
    # fresh dir per run unless the caller pins one — a reused dir would
    # let keep-k GC favor a previous (longer) run's higher step numbers
    # and the restore proof below would resurrect stale parameters
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix=f"ckpt_gnn_p{cfg.partitions}_")
    t0 = time.perf_counter()
    rep = tr.fit_supervised(args.steps, ckpt_dir,
                            ckpt_every=max(args.steps // 2, 1))
    t_fit = time.perf_counter() - t0
    acc = tr.evaluate()
    halo_note = (f" halo_hit={tr.halo_hit_rate:.3f}"
                 if plan.halo_budget > 0 else "")
    print(f"[result] {rep.steps_run} global steps "
          f"({rep.steps_run * plan.parts} partition mini-batches), "
          f"checkpoints={rep.checkpoints} acc={acc:.4f} "
          f"cache_hit={tr.cache_hit_rate:.3f}{halo_note}")
    # restart-path proof: rebuild a fresh trainer and restore the committed
    # checkpoint (the same machinery a partitions restart uses)
    t0 = time.perf_counter()
    tr2 = make_trainer(graph, cfg, seed=args.seed, device=args.device)
    t_rebuild = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = tr2.restore(CheckpointManager(ckpt_dir, async_save=False))
    t_restore = time.perf_counter() - t0
    print(f"[restore] fresh trainer restored from step {step} "
          f"(global_steps={tr2.global_steps}) acc={tr2.evaluate():.4f}")
    return {"trainer": tr, "report": rep, "restored": tr2,
            "ckpt_dir": ckpt_dir,
            "seconds": {"build": t_build, "fit": t_fit,
                        "rebuild": t_rebuild, "restore": t_restore}}


def run_autotune(args, tr) -> Dict:
    """``tr.fit_autotuned`` with ``--episodes-autotune`` episodes of
    ``--steps`` steps; prints each episode, the best and the Pareto count.
    Returns the trainer and the ``AutotuneReport``."""
    acfg = tr.cfg.autotune.replace(episodes=args.episodes_autotune,
                                   steps_per_episode=args.steps,
                                   seed=args.seed)
    rep = tr.fit_autotuned(acfg)
    for ep in rep.episodes:
        c, m = ep.config, ep.metrics
        print(f"[episode {ep.index}] γ={c['bias_rate']:.2f} "
              f"Θ={c['cache_volume_mb']:.2f}MB "
              f"mode={c['parallel_mode']} workers={int(c['workers'])} | "
              f"thr={m['throughput']:.2f} steps/s "
              f"mem={m['memory']/2**20:.1f} MiB acc={m['accuracy']:.3f} "
              f"hit={ep.cache_hit_rate:.2f}")
    b, m = rep.best, rep.best.metrics
    print(f"[autotune] best=episode {b.index} "
          f"thr={m['throughput']:.2f} steps/s "
          f"(baseline {rep.baseline_metrics['throughput']:.2f}) "
          f"changed={sorted(rep.changed_knobs())}")
    print(f"[pareto] {len(rep.pareto_points())} non-dominated "
          f"measured points")
    return {"trainer": tr, "report": rep}


def run_gnn(args) -> Dict:
    """Train ``args.steps`` steps per epoch and print the result and the
    stage split.  Returns the trainer and its ``RunResult``; with
    ``--partitions`` > 1, what ``run_gnn_multipartition`` returns; with
    ``--autotune``, what ``run_autotune`` returns."""
    from repro_torch.configs import get_config
    from repro_torch.core.a3gnn import A3GNNTrainer, apply_baseline
    from repro_torch.graph.synthetic import dataset_like

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.mode:
        cfg = cfg.replace(parallel_mode=args.mode)
    if args.bias_rate is not None:
        cfg = cfg.replace(bias_rate=args.bias_rate)
    if args.partitions is not None:
        cfg = cfg.replace(partitions=args.partitions)
    if args.halo_budget is not None:
        cfg = cfg.replace(halo_budget=args.halo_budget)
    if args.halo_refresh_interval is not None:
        cfg = cfg.replace(halo_refresh_interval=args.halo_refresh_interval)
    if args.rebalance_drift is not None:
        cfg = cfg.replace(rebalance_drift=args.rebalance_drift)
    if args.sampling_device is not None:
        cfg = cfg.replace(sampling_device=args.sampling_device)
    if args.fused_gather_agg:
        cfg = cfg.replace(fused_gather_agg=True)
    cfg = apply_baseline(cfg, args.baseline)
    graph = dataset_like(cfg, seed=args.seed)
    print(f"[data] {graph.name}: {graph.num_nodes} nodes, "
          f"{graph.num_edges} edges")
    if cfg.partitions > 1:
        return run_gnn_multipartition(args, cfg, graph)
    tr = A3GNNTrainer(graph, cfg, seed=args.seed, device=args.device)
    if args.autotune:
        return run_autotune(args, tr)
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
                    help="data-parallel graph partitions (scale-out path; "
                         "every partition on the one --device)")
    ap.add_argument("--halo-budget", type=int, default=None,
                    help="per-partition cap on boundary feature rows "
                         "exchanged through the mesh (0 = drop cut edges, "
                         "the paper's no-remote-access setting)")
    ap.add_argument("--halo-refresh-interval", type=int, default=None,
                    help="re-run the bounded halo exchange every N global "
                         "steps when streamed feature updates left halo "
                         "copies stale (0 = explicit refresh only)")
    ap.add_argument("--rebalance-drift", type=float, default=None,
                    help="cut-fraction drift past the plan baseline that "
                         "triggers an incremental partition re-balance "
                         "between global steps on a mutating graph "
                         "(boundary-node migration; <= 0 disables)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory of the multi-partition path "
                         "(default: a fresh temporary directory)")
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
                    help="run the online auto-tuning controller (§III-C)")
    ap.add_argument("--episodes-autotune", type=int, default=4)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.arch.startswith("graphsage"):
        raise SystemExit(f"LM training: {NOT_PORTED}")
    run_gnn(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
