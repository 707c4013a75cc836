"""Serving entry point of the port — two engines behind one CLI.

LM token decode (continuous batching over prompts, the dense LMs):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --smoke \
      --requests 16 --batch 4 --max-new 12

Online GNN node inference over the training-side FeaturePlane (trains
briefly to warm the parameters and the γ/Θ cache, serves node queries,
then applies a streamed feature update mid-serving and queries the node
again):

  PYTHONPATH=src python -m repro_torch.launch.serve --gnn \
      --arch graphsage-products --sampling-device device --queries 64 --batch 4

Everything runs on ``--device`` (default ``cuda``); ``--device cpu`` runs
the plain versions of the kernels on the host.  The LM families other than
dense and the partition-routed fabric (``--partitions`` > 1) are not
ported yet.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

NOT_PORTED = "not ported yet — see ROADMAP.md"


def run_lm_serve(args, params=None) -> Dict:
    """Serve ``args.requests`` random prompts through the decode engine.
    ``params`` (f32 masters on ``args.device``) default to the engine's
    seeded ones.  Prints one result line; returns the engine and the drain
    summary."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import Engine, Request

    try:
        cfg = get_config(args.arch, smoke=args.smoke)
    except KeyError:        # the other LM families are not registered yet
        cfg = None
    if getattr(cfg, "family", None) != "dense":
        raise SystemExit(f"LM serving of --arch {args.arch}: {NOT_PORTED}")
    eng = Engine(cfg, params=params, batch=args.batch, max_len=args.max_len,
                 temperature=args.temperature, seed=args.seed,
                 device=args.device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(2, args.prompt_len + 1))
        prompt = rng.integers(1, cfg.vocab_size, plen).astype(np.int32)
        eng.submit(Request(rid=rid, prompt=prompt,
                           max_new_tokens=args.max_new))
    stats = eng.run_to_completion()
    print(f"[result] {stats['completed']} requests, {stats['tokens']} tokens "
          f"in {stats['seconds']:.2f}s → {stats['tokens_per_s']:.1f} tok/s; "
          f"TTFT p50 {stats['ttft_p50_ms']:.1f} ms "
          f"p99 {stats['ttft_p99_ms']:.1f} ms (device={eng.device})")
    return {"engine": eng, "stats": stats}


def run_gnn_serve(args) -> Dict:
    """Warm up, serve, stream an update, re-query.  Prints one line per
    phase and returns what a caller needs to check the run: the trainer,
    the engine, the warm-up ``PipelineStats``, the serving stats, the
    re-query and the ``cache_gather`` launches of each phase."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.a3gnn import A3GNNTrainer
    from repro_torch.graph.storage import FeatureStore
    from repro_torch.graph.synthetic import dataset_like
    from repro_torch.kernels.gather.ops import cache_gather
    from repro_torch.serve.gnn_engine import GNNInferenceEngine, GNNRequest

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.sampling_device:
        cfg = cfg.replace(sampling_device=args.sampling_device)
    if args.partitions > 1:
        raise SystemExit(f"--partitions > 1: {NOT_PORTED}")
    graph = dataset_like(cfg, seed=args.seed)
    print(f"[data] {graph.name}: {graph.num_nodes} nodes, "
          f"{graph.num_edges} edges, {graph.num_classes} classes")

    launches0 = cache_gather.launches
    tr = A3GNNTrainer(graph, cfg, seed=args.seed, device=args.device)
    pipe = tr.make_pipeline()
    try:
        warm = pipe.run(max_steps=args.train_steps)
    finally:
        pipe.shutdown()               # workers down; the plane stays live
    launches_warm = cache_gather.launches - launches0
    hits_trained = tr.cache.stats.hits if tr.cache else 0
    print(f"[train] {warm.steps} steps warmed the cache: "
          f"{hits_trained} hits, hit_rate={tr.cache_hit_rate:.3f}; "
          f"losses {warm.losses}; cache_gather launches {launches_warm}")

    launches0 = cache_gather.launches
    eng = GNNInferenceEngine.from_trainer(tr, batch=args.batch,
                                          plane=pipe.plane, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    test_ids = np.where(graph.test_mask)[0]
    nodes = rng.choice(test_ids, size=args.queries, replace=True)
    for rid, v in enumerate(nodes):
        eng.submit(GNNRequest(rid=rid, node=int(v)))
    stats = eng.run_to_completion()
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    launches_serve = cache_gather.launches - launches0
    print(f"[serve] {stats['completed']} queries in {stats['seconds']:.2f}s "
          f"→ {stats['queries_per_s']:.1f} q/s over "
          f"{stats['engine_steps']} engine steps "
          f"(batch={args.batch}, backend={eng.plane.backend}, "
          f"device={tr.device}); latency p50 {stats['p50_ms']:.1f} ms "
          f"p99 {stats['p99_ms']:.1f} ms; cache_gather launches "
          f"{launches_serve}")
    if tr.cache is not None:
        print(f"[plane] shared with training: hits {hits_trained} → "
              f"{tr.cache.stats.hits} (serving added "
              f"{tr.cache.stats.hits - hits_trained}), "
              f"hit_rate={tr.cache.stats.hit_rate:.3f}")
    served = list(eng.completed)

    # streaming update mid-serving: the store fans the row out through the
    # plane (cache-resident copy + device-mirror re-sync), so the re-query
    # sees the drifted feature immediately
    store = FeatureStore(graph)
    eng.plane.subscribe_to(store)
    node = int(nodes[0])
    before = served[0].pred
    store.update_rows(np.array([node]),
                      np.full((1, graph.feat_dim), 1.0, np.float32))
    eng.submit(GNNRequest(rid=args.queries, node=node))
    eng.run_to_completion()
    requery = eng.completed[-1]
    print(f"[stream] update_rows(node {node}) → store v{store.version}; "
          f"re-query pred {before} → {requery.pred} "
          f"(drift observed through the live plane)")
    return {"trainer": tr, "engine": eng, "warmup": warm, "stats": stats,
            "served": served, "requery": requery,
            "launches_warmup": launches_warm,
            "launches_serve": launches_serve}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where parameters, the forward, the KV cache and "
                         "a device plane's cache table live")
    ap.add_argument("--batch", type=int, default=4)
    # LM decode knobs
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--gnn", action="store_true",
                    help="serve online GNN node predictions through the "
                         "training-side FeaturePlane (serve/gnn_engine.py); "
                         "implied when --arch names a GNN config "
                         "(graphsage-*)")
    ap.add_argument("--queries", type=int, default=16,
                    help="node-prediction requests to serve (--gnn)")
    ap.add_argument("--train-steps", type=int, default=4,
                    help="brief training steps to warm params + cache "
                         "before serving (--gnn)")
    ap.add_argument("--sampling-device", default=None,
                    choices=[None, "cpu", "device", "auto"],
                    help="feature-plane backend for the serving gather")
    ap.add_argument("--partitions", type=int, default=1,
                    help="> 1 serves through the partition-routed fabric "
                         "(not ported yet)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.gnn or args.arch.startswith("graphsage"):
        run_gnn_serve(args)
    else:
        run_lm_serve(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
