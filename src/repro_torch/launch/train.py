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
trainer that restores the committed checkpoint.  On a machine with at
least ``--partitions`` cards it spawns one process per partition, rank r
on ``cuda:r``, joined by ``nccl`` (``spawn_gnn_multipartition``, over
``launch/group.py``); rank 0 prints.  With fewer cards every partition
runs on the one ``--device`` in this process.  ``--autotune`` trains the single-partition trainer
under the online auto-tuner (``fit_autotuned``: ``--episodes-autotune``
episodes of ``--steps`` steps each); the fleet's live reconfiguration
(halo-budget swaps, rebalances, streamed updates and the auto-tuner with
its ``partitions`` restart) runs a process a partition through
``autotune_rank``, spawned by ``launch/group.spawn_partitions`` at
``max(partitions, max_partitions)`` processes:

  PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage-products \
      --sampling-device device --fused-gather-agg --autotune \
      --episodes-autotune 4 --steps 10

Any other ``--arch`` is an LM (``run_lm``, the JAX package's LM path):
seeded f32 parameters, ``get_optimizer(cfg)``, ``make_train_step`` through
the fault-tolerance supervisor over a ``PrefetchLoader`` of
``SyntheticTokens``, with checkpoints every ``steps // 3`` steps (keep 2,
written asynchronously):

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --steps 6 --batch 8 --seq 128 --workers 2 --ckpt-dir DIR
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import sys
import tempfile
import time
from typing import Dict


def run_gnn_multipartition(args, cfg, graph) -> Dict:
    """Scale-out GNN path: locality-partitioned data parallelism under the
    fault-tolerance supervisor, with a restart-path restore proof.  Returns
    the trainer, the supervisor's report, the restored trainer, the
    checkpoint directory, the accuracies and the host seconds of each
    part.  Inside a ``torch.distributed`` group of ``cfg.partitions``
    processes it runs as each rank's code (every rank runs it whole; the
    checkpoint directory is rank 0's)."""
    from repro_torch.core.a3gnn import make_trainer
    from repro_torch.distributed.collectives import all_gather_objects
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
    ckpt_dir = args.ckpt_dir or all_gather_objects(
        tr.mesh, tempfile.mkdtemp(prefix=f"ckpt_gnn_p{cfg.partitions}_")
        if tr.mesh.rank == 0 else None)[0]
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
    acc2 = tr2.evaluate()
    print(f"[restore] fresh trainer restored from step {step} "
          f"(global_steps={tr2.global_steps}) acc={acc2:.4f}")
    return {"trainer": tr, "report": rep, "restored": tr2,
            "ckpt_dir": ckpt_dir, "acc": acc, "restored_step": step,
            "restored_acc": acc2,
            "seconds": {"build": t_build, "fit": t_fit,
                        "rebuild": t_rebuild, "restore": t_restore}}


def _named_numpy(state) -> Dict:
    from repro_torch.train.checkpoint import _flatten_with_names, _to_host
    return {f"{group}/{name}": _to_host(leaf)
            for group, tree in state.items()
            for name, leaf in _flatten_with_names(tree)}


def multipartition_summary(rep: Dict) -> Dict:
    """What ``run_gnn_multipartition`` ran, as numpy and numbers, for the
    partitions this process holds (every partition on a host-simulated
    mesh, its rank's in a group): each one's losses, the writer's and the
    restored trainer's params and ``opt_state`` by checkpoint name, and
    what every partition shares (accuracies, hit rates, the supervisor's
    report).  Over a group a collective: every rank calls it."""
    tr, tr2 = rep["trainer"], rep["restored"]
    out = {"report": dataclasses.asdict(rep["report"]),
           "global_steps": tr.global_steps,
           "acc": rep["acc"], "restored_acc": rep["restored_acc"],
           "restored_step": rep["restored_step"],
           "restored_global_steps": tr2.global_steps,
           "state": _named_numpy(tr.state_dict()),
           "restored_state": _named_numpy(tr2.state_dict()),
           "cache_hit_rate": tr.cache_hit_rate,
           "halo_hit_rate": tr.halo_hit_rate,
           "halo_exchange_bytes": tr.halo_exchange_bytes,
           "fused_grad_calls": tr.fused_grad_calls,
           "seconds": rep["seconds"],
           "losses": {s.index: list(s.pipe.stats.losses) for s in tr.slots}}
    return out


def halo_rows(tr) -> Dict:
    """Each held partition's halo rows (``plan.halo_sets``) as its feature
    plane serves them.  A fetch counts in the cache statistics: read those
    first."""
    import numpy as np
    return {s.index: s.pipe.plane.fetch(np.arange(
        s.n_owned, s.n_owned + len(tr.plan.halo_sets[s.index])))
        for s in tr.slots}


def gnn_rank(rank: int, device, args, cfg=None, timed_steps: int = 0,
             capture: bool = False) -> Dict:
    """One rank of the multi-partition run in a ``torch.distributed``
    group (``launch/group.spawn_partitions`` calls it): the graph and
    ``run_gnn_multipartition`` on ``device``, rank 0 printing (with
    ``capture``, into the result's ``stdout`` instead); then
    ``timed_steps`` more global steps, each to the card's last kernel.
    Returns ``multipartition_summary`` with its partition's
    ``halo_rows``, this process's kernel ``launches`` over the run, the
    timed steps' host seconds, the printed text and the top-level modules
    the process imported."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.launch.group import imported_modules
    device = torch.device(device)
    args = argparse.Namespace(**{**vars(args), "device": str(device)})
    cfg = cfg if cfg is not None else gnn_config(args)
    text = io.StringIO()
    quiet = rank != 0 or capture
    with contextlib.redirect_stdout(text if quiet else sys.stdout):
        graph = load_graph(args, cfg)
        before = launch_counts()
        rep = run_gnn_multipartition(args, cfg, graph)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches = {k: n - before[k] for k, n in launch_counts().items()}
    try:
        out = multipartition_summary(rep)
        out["halo_rows"] = halo_rows(rep["trainer"])
        walls = []
        for _ in range(timed_steps):
            t0 = time.perf_counter()
            rep["trainer"].global_step()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t0)
    finally:
        for t in (rep["trainer"], rep["restored"]):
            for slot in t.slots:
                slot.pipe.shutdown()
    return {**out, "rank": rank, "launches": launches, "step_seconds": walls,
            "stdout": text.getvalue() if rank == 0 else "",
            "modules": imported_modules()}


def spawn_gnn_multipartition(args, cfg) -> Dict:
    """``cfg.partitions`` processes, rank r on ``cuda:r``, joined by
    ``nccl``, each running ``gnn_rank``.  The kernels are built here once
    (the ranks load the libraries) and the checkpoint directory made here,
    so every rank writes and reads the same.  Returns each rank's summary
    and the checkpoint directory."""
    from repro_torch.kernels.build import build
    from repro_torch.launch.group import spawn_partitions
    build(["gather", "segment_agg", "fused_gather_agg"])
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix=f"ckpt_gnn_p{cfg.partitions}_")
    rank_args = argparse.Namespace(**{**vars(args), "ckpt_dir": ckpt_dir})
    ranks = spawn_partitions(
        gnn_rank, cfg.partitions, "nccl",
        [f"cuda:{r}" for r in range(cfg.partitions)], args=(rank_args, cfg))
    return {"ranks": ranks, "ckpt_dir": ckpt_dir}


def _held(tr) -> bool:
    return getattr(tr, "holds_partition", True)


def streamed_rows(tr, seed: int, n: int):
    """Global ids of the first ``n`` halo rows of every partition (each
    owned by another partition) and seeded new values for them: the same
    on every process, from the plan each one holds whole."""
    import numpy as np
    ids = np.unique(np.concatenate(
        [hs[:n] for hs in tr.plan.halo_sets] or [np.zeros(0, np.int64)]
    ).astype(np.int64))
    rng = np.random.default_rng(seed)
    return ids, rng.standard_normal(
        (len(ids), tr.full_graph.feat_dim)).astype(np.float32)


def fleet_summary(tr) -> Dict:
    """For the partitions this process holds: the params and
    ``opt_state`` by checkpoint name, the hit rates, the manifest's payload
    (``checkpoint_extra``) and the halo rows through the planes (read last:
    a fetch counts in the cache statistics).  Over a group a collective of
    the partition processes."""
    out = {"partitions": tr.cfg.partitions, "held": _held(tr)}
    if _held(tr):
        out.update(state=_named_numpy(tr.state_dict()),
                   cache_hit_rate=getattr(tr, "cache_hit_rate", None),
                   halo_hit_rate=getattr(tr, "halo_hit_rate", None),
                   manifest=tr.checkpoint_extra())
        if hasattr(tr, "slots"):
            out["halo_rows"] = halo_rows(tr)
    return out


def _live_op(tr, name: str, arg, rec: Dict):
    """One live operation of ``autotune_rank`` on this process's share of
    the fleet; what it reports goes into ``rec``.  A process with no
    partition applies only what every process's copy of the full graph
    receives (topology edits, feature updates) and records the rest."""
    import numpy as np

    from repro_torch.graph.storage import FeatureStore
    held = _held(tr)
    if name == "steps":
        if held:
            before = {s.index: len(s.pipe.stats.losses) for s in tr.slots}
            refresh, rec["refresh_seconds"] = (tr.refresh_halo_features,
                                               [])

            def timed_refresh():              # a periodic refresh's seconds
                t0 = time.perf_counter()
                volume = refresh()
                rec["refresh_seconds"].append(time.perf_counter() - t0)
                return volume
            tr.refresh_halo_features = timed_refresh
            try:
                for _ in range(int(arg)):
                    tr.global_step()
            finally:
                del tr.refresh_halo_features
            rec["losses"] = {s.index: list(s.pipe.stats.losses[
                before[s.index]:]) for s in tr.slots}
            rec["halo_refreshes"] = tr.halo_refreshes
    elif name == "halo":
        if held:
            tr.set_halo_budget(int(arg))
            rec["halo_exchange_bytes"] = tr.halo_exchange_bytes
    elif name == "edges":
        seed, n = arg
        rng = np.random.default_rng(seed)
        g = tr.full_graph
        rec["added"] = g.add_edges(rng.integers(0, g.num_nodes, n),
                                   rng.integers(0, g.num_nodes, n))
        rec["topology_version"] = g.topology_version
    elif name == "rebalance":
        if held:
            res = tr.rebalance_partitions()
            rec.update(moved_nodes=res.moved_nodes, cut_before=res.cut_before,
                       cut_after=res.cut_after,
                       halo_exchange_bytes=tr.halo_exchange_bytes)
    elif name == "update":
        if not held:
            raise ValueError("the streamed rows come from the plan: every "
                             "process of the group holds a partition here")
        seed, n = arg
        if tr.feature_store is None:
            tr.attach_feature_store(FeatureStore(tr.full_graph))
        ids, rows = streamed_rows(tr, seed, n)
        rec["rows"] = len(ids)
        rec["version"] = tr.feature_store.update_rows(ids, rows)
        rec["halo_dirty"] = tr._halo_dirty
    elif name == "snapshot":
        rec.update(fleet_summary(tr))
    else:
        raise ValueError(f"unknown live operation {name!r}")


def _autotune_op(tr, args, kw: Dict, script, rec: Dict):
    """``fit_autotuned`` with ``--episodes-autotune`` episodes of
    ``--steps`` steps, ``kw`` overriding the ``AutotuneConfig`` (``script``
    there, or the argument, a list of proposals that replaces
    ``propose``).  Records every episode, each one's losses (over every
    partition), this process's MEASURE wall seconds, the host seconds of
    each RECONFIGURE and restart and each restart's manifest (a process
    with no partition in an episode records None for its losses and
    wall).  Returns the trainer the run left live."""
    import dataclasses as dc

    from repro_torch.core.autotune.controller import fit_autotuned
    kw = dict(kw)
    script = kw.pop("script", script)
    acfg = tr.cfg.autotune.replace(**{
        "episodes": args.episodes_autotune, "steps_per_episode": args.steps,
        "seed": args.seed, **kw})
    losses, seconds, manifests, box = [], [], [], {}

    def configure(ctrl):
        box["ctrl"] = ctrl
        if script is not None:
            proposals = iter(script)
            ctrl.propose = lambda: (dict(next(proposals)), None)
        measure, apply, restart = (ctrl.measure, ctrl._apply_config,
                                   ctrl._restart)

        def measured(index, cfg, predicted=None):
            ep = measure(index, cfg, predicted)
            losses.append(list(ctrl.pipe.stats.losses)
                          if ctrl.holds_partition else None)
            return ep

        def applied(cfg):
            t0 = time.perf_counter()
            apply(cfg)
            seconds.append(("reconfigure", time.perf_counter() - t0))

        def restarted(new_partitions, halo_budget=None):
            t0 = time.perf_counter()
            restart(new_partitions, halo_budget)
            seconds.append(("restart", time.perf_counter() - t0))
            manifests.append(ctrl._restart_mgr.read_manifest(
                ctrl.restarts)["extra"])
        ctrl.measure, ctrl._apply_config, ctrl._restart = (
            measured, applied, restarted)

    rep = fit_autotuned(tr, acfg, configure=configure)
    rec.update(episodes=[dc.asdict(ep) for ep in rep.episodes],
               best=rep.best.index, losses=losses,
               reconfigure_seconds=seconds,
               manifests=manifests, t_walls=box["ctrl"].t_walls)
    return rep.final_trainer


def autotune_rank(rank: int, device, args, cfg=None, script=None,
                  ops=None) -> Dict:
    """One process of the fleet's live reconfiguration: the graph, this
    process's share of a ``cfg.partitions`` fleet (``make_rank_trainer``)
    on ``device``, then ``ops`` in order, each a ``(name, arg)``:

      ``("steps", n)``            n global steps
      ``("halo", budget)``        ``set_halo_budget``
      ``("edges", (seed, n))``    n seeded random edges added to the graph
      ``("rebalance", None)``     ``rebalance_partitions``
      ``("update", (seed, n))``   ``FeatureStore.update_rows`` of
                                  ``streamed_rows(tr, seed, n)`` (a store
                                  attached on the first)
      ``("snapshot", None)``      ``fleet_summary`` at that point
      ``("autotune", kw)``        ``fit_autotuned`` (``_autotune_op``);
                                  the trainer it leaves live goes on

    (default: one ``("autotune", {})``).  Inside a ``torch.distributed``
    group every process runs the same ``ops`` (``launch/group
    .spawn_partitions`` calls it with the rank first); outside one it is
    the host-simulated run of the same sequence.  Returns numpy and
    numbers: a record of each op (its host seconds on this process, what
    it reports), ``fleet_summary`` at the end, this process's kernel
    launches over the call and the top-level modules it imported."""
    import torch

    from repro_torch.core.multipart import make_rank_trainer
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.group import imported_modules
    device = torch.device(device)
    args = argparse.Namespace(**{**vars(args), "device": str(device)})
    cfg = cfg if cfg is not None else gnn_config(args)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        graph = load_graph(args, cfg)
    before = launch_counts()
    tr = make_rank_trainer(graph, cfg, seed=args.seed, device=device)
    records = []
    try:
        for name, arg in ops if ops is not None else [("autotune", {})]:
            rec = {"op": name}
            t0 = time.perf_counter()
            if name == "autotune":
                tr = _autotune_op(tr, args, arg, script, rec)
            else:
                _live_op(tr, name, arg, rec)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            rec["seconds"] = time.perf_counter() - t0
            records.append(rec)
        out = {"ops": records, **fleet_summary(tr)}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["launches"] = {k: n - before[k]
                           for k, n in launch_counts().items()}
    finally:
        for slot in getattr(tr, "slots", []):
            slot.pipe.shutdown()
    return {**out, "rank": rank, "modules": imported_modules()}


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


def gnn_config(args):
    """The GNN configuration the command line names."""
    from repro_torch.configs import get_config
    from repro_torch.core.a3gnn import apply_baseline

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
    return apply_baseline(cfg, args.baseline)


def load_graph(args, cfg):
    """The seeded synthetic twin of ``cfg``'s dataset; prints its size."""
    from repro_torch.graph.synthetic import dataset_like
    graph = dataset_like(cfg, seed=args.seed)
    print(f"[data] {graph.name}: {graph.num_nodes} nodes, "
          f"{graph.num_edges} edges")
    return graph


def _spawns_ranks(cfg, device) -> bool:
    """A card for each partition and no group yet: one process each."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import device_count
    return (cfg.partitions > 1 and device_count(device) >= cfg.partitions
            and not (dist.is_available() and dist.is_initialized()))


def run_gnn(args) -> Dict:
    """Train ``args.steps`` steps per epoch and print the result and the
    stage split.  Returns the trainer and its ``RunResult``; with
    ``--partitions`` > 1, what ``run_gnn_multipartition`` returns (what
    ``spawn_gnn_multipartition`` returns where it spawns the ranks); with
    ``--autotune``, what ``run_autotune`` returns."""
    from repro_torch.core.a3gnn import A3GNNTrainer

    cfg = gnn_config(args)
    if _spawns_ranks(cfg, args.device):
        return spawn_gnn_multipartition(args, cfg)
    graph = load_graph(args, cfg)
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


def run_lm(args) -> Dict:
    """The LM training path: prints ``step k: loss=… gnorm=…`` and
    ``[result] N steps in …s (… tok/s), checkpoints=…``.  Returns the
    model, the final state, the supervisor's report, the history (step,
    loss, gradient norm, host clock at the step's start and end) and the
    seconds of the run.  Without ``--ckpt-dir`` the checkpoints go to a
    temporary directory, printed when the run starts and removed when it
    ends, on success or error; a directory the caller names is kept."""
    if args.ckpt_dir:
        return _run_lm(args, args.ckpt_dir)
    with tempfile.TemporaryDirectory(prefix=f"ckpt_{args.arch}_",
                                     ignore_cleanup_errors=True) as ckpt_dir:
        print(f"[ckpt] {ckpt_dir} (temporary: removed at the end of the "
              f"run)", flush=True)
        return _run_lm(args, ckpt_dir)


def _run_lm(args, ckpt_dir) -> Dict:
    """``run_lm`` with its checkpoints in ``ckpt_dir``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    from repro_torch.models.params import init_params
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import (PrefetchLoader, SyntheticTokens,
                                        to_device)
    from repro_torch.train.fault_tolerance import TrainSupervisor
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.trainer import make_train_step

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    model = build(cfg)
    opt = get_optimizer(cfg)
    step_fn, _ = make_train_step(model, cfg, opt)
    params = init_params(model.decls,
                         torch.Generator(device=args.device).manual_seed(
                             args.seed), args.device,
                         dtype_override=getattr(torch, cfg.param_dtype))
    opt_state = opt.init(params)
    data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq,
                           seed=args.seed, n_batches=args.steps)
    loader = PrefetchLoader(data, workers=args.workers)
    ckpt = CheckpointManager(ckpt_dir, keep=2, async_save=True)

    state = {"params": params, "opt_state": opt_state}
    it = iter(loader)
    history = []

    def one_step(state, step):
        t_start = time.perf_counter()
        batch = to_device(next(it), args.device)
        p, o, metrics = step_fn(state["params"], state["opt_state"], batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        history.append((step, loss, gnorm, t_start, time.perf_counter()))
        if step % max(args.steps // 10, 1) == 0:
            print(f"  step {step}: loss={loss:.4f} gnorm={gnorm:.3f}",
                  flush=True)
        return {"params": p, "opt_state": o}

    sup = TrainSupervisor(ckpt, ckpt_every=max(args.steps // 3, 1))
    t0 = time.perf_counter()
    try:
        state, rep = sup.run(state, one_step, args.steps)
    except BaseException:
        try:
            ckpt.wait()         # no writer left in the directory
        except Exception as e:  # noqa: BLE001 — the step's error is raised
            print(f"[ckpt] the checkpoint writer failed too: {e!r}",
                  file=sys.stderr, flush=True)
        raise
    ckpt.wait()
    dt = time.perf_counter() - t0
    toks = args.steps * args.batch * args.seq
    print(f"[result] {args.steps} steps in {dt:.1f}s "
          f"({toks/dt:.0f} tok/s), checkpoints={rep.checkpoints}")
    return {"model": model, "state": state, "report": rep,
            "history": history, "seconds": dt}


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
                    help="data-parallel graph partitions (scale-out path: "
                         "one process a card, cuda:r, joined by nccl where "
                         "there are as many cards; otherwise every "
                         "partition on the one --device)")
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
                    help="checkpoint directory of the multi-partition and "
                         "LM paths (default: a fresh temporary directory)")
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
    # LM knobs
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the LM's stack to N layers, at full width "
                         "(default: the configuration's depth)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.arch.startswith("graphsage"):
        run_gnn(args)
    else:
        run_lm(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
