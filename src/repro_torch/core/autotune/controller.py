"""Online auto-tuning controller — closes the paper's adaptive loop (§III-C).

``AutotuneController`` runs a LIVE ``A3GNNTrainer`` + ``Pipeline`` pair
through a sequence of tuning *episodes*.  Where the offline tools in this
package (``ppo.py``, ``surrogate.py``, ``pareto.py``) explore a design
space against a model, the controller applies each chosen configuration to
the running trainer and feeds *measured* points back — the
affordable/adaptive/automatic loop of the paper title.

Episode lifecycle
-----------------

Each episode ``e = 0, 1, …`` goes through four phases:

1. **PROPOSE** — episode 0 measures the fixed seed configuration (the
   baseline every later episode must beat).  Episodes ≥ 1 run a short PPO
   burst (Algo. 3) against the surrogate and take the burst's
   best-predicted configuration that has not been measured yet, so every
   episode visits a *new* point of the design space.
2. **RECONFIGURE** — the pipeline is drained (every in-flight mini-batch is
   trained; nothing is dropped), then the proposal is applied live:
   ``FeatureCache.resize`` (hit/miss accounting is preserved), the
   sampler's bias weight γ is swapped via a fresh ``bias_weight_fn``, and
   the executor switches parallel mode / worker count.  Training then
   resumes — parameters, optimizer state and step count all carry over.
3. **MEASURE** — ``steps_per_episode`` real training steps run under the
   new configuration.  Throughput comes from the wall clock
   (``PipelineStats.throughput_steps_per_s``) on multi-core hosts, where
   threads physically overlap; on a 1-core host it is modeled from the
   *measured* per-stage times via Eqs. 2/4 instead (overlap is impossible
   there, so the wall clock would under-report every parallel mode) —
   ``resolve_throughput_source`` picks per ``AutotuneConfig.
   throughput_source``.  Memory comes from Eqs. 3/5 with the measured
   peak batch size, accuracy from a held-out evaluation.
4. **FEEDBACK** — the measured (throughput, memory, accuracy) point is
   appended to the surrogate's training set (which was pre-warmed from the
   analytic models in ``core/perf_model.py`` + ``core/locality.py``) and
   the surrogate is refit, so the next episode's proposal sees every real
   measurement.  The Pareto frontier is maintained over MEASURED points
   only.

The recommendation (``AutotuneReport.best``) is the measured episode with
the highest reward ``w·(throughput, −memory, accuracy)`` subject to the
``memory_limit_bytes`` constraint; ``T*``/``M*`` endpoints come off the
measured Pareto front exactly as in Tab. II.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.gnn import AutotuneConfig
from repro_torch.core.autotune.pareto import pareto_front
from repro_torch.core.autotune.ppo import PPOAgent, PPOConfig, VIOLATION_REWARD
from repro_torch.core.autotune.space import Knob, Space, DEVICES, MODES
from repro_torch.core.autotune.surrogate import Surrogate
from repro_torch.core.locality import accuracy_drop_model, expected_hit_rate
from repro_torch.core.perf_model import (MemoryTerms, StageTimes,
                                   bottleneck_step_time, memory_mode1,
                                   memory_mode2, memory_seq)

# relative cost of a cache hit vs a host fetch during batch generation —
# scales the analytic t_batch estimate used only for surrogate pre-warming
HIT_SPEEDUP = 0.6
# prior for the device plane's batch-generation advantage (resident rows
# gathered in HBM instead of copied through host memory) — surrogate
# pre-warm only; MEASURE always uses the real pipeline
DEVICE_BATCH_SPEEDUP = 0.7


def available_cpus() -> int:
    """CPUs actually usable by THIS process: the scheduler affinity mask
    (respects cgroup/taskset pinning — a 1-CPU container on an 8-core host
    must count as 1), falling back to ``os.cpu_count()`` where affinity is
    not exposed (macOS)."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0)) or 1
    return os.cpu_count() or 1


def resolve_throughput_source(acfg: AutotuneConfig) -> str:
    """MEASURE-phase throughput source: ``modeled`` (Eqs. 2/4 from measured
    stage times) or ``wallclock`` (``PipelineStats.throughput_steps_per_s``).
    ``auto`` picks wall-clock whenever the process can use more than one
    core — threads can physically overlap there, so the wall clock is the
    truth; on a 1-core host overlap is impossible and the model is the
    only honest multi-core prediction."""
    src = acfg.throughput_source
    if src == "auto":
        src = "wallclock" if available_cpus() > 1 else "modeled"
    if src not in ("modeled", "wallclock"):
        raise ValueError(f"unknown throughput_source: {src!r}")
    return src


def tuned_runtime_status() -> Dict[str, bool]:
    """Which scripts/env_tuned.sh host-tuning knobs are live in THIS
    process: ``tcmalloc`` (LD_PRELOAD carries a tcmalloc build — allocator
    lock contention shapes the multi-worker wall clock) and
    ``xla_host_flags`` (host platform pinned to one device, so jit
    dispatch cost is stable across runs).  Wall-clock MEASURE numbers are
    comparable only against numbers taken under the same runtime, so the
    controller stamps this onto every wall-clock episode.  The port runs no
    XLA, so ``xla_host_flags`` changes nothing here; it stays so that the
    two packages' reports keep one shape."""
    tcmalloc = "tcmalloc" in os.environ.get("LD_PRELOAD", "")
    xla = "--xla_force_host_platform_device_count" in \
        os.environ.get("XLA_FLAGS", "")
    return {"tcmalloc": tcmalloc, "xla_host_flags": xla,
            "tuned": tcmalloc and xla}


def episode_space(acfg: AutotuneConfig) -> Space:
    """The tunable subset of Table I.  γ, Θ, mode, workers — and, when
    gated on, batch size, the sampling device (feature-plane backend) and
    the halo budget — swap live at an episode boundary; with
    ``max_partitions > 1`` the partition count joins the space and is
    applied through the restart-capable path (checkpoint → rebuild
    trainer → restore)."""
    knobs = [
        Knob("bias_rate", "log", 1.0, acfg.max_bias_rate),
        Knob("cache_volume_mb", "log", 0.05, acfg.max_cache_mb),
        Knob("parallel_mode", "cat", choices=MODES),
        Knob("workers", "int", 1, acfg.max_workers),
    ]
    if acfg.max_batch_size > 0:
        knobs.append(Knob("batch_size", "int",
                          min(16, acfg.max_batch_size), acfg.max_batch_size))
    if acfg.tune_sampling_device:
        knobs.append(Knob("sampling_device", "cat", choices=DEVICES))
    if acfg.max_partitions > 1:
        knobs.append(Knob("partitions", "int", 1, acfg.max_partitions))
    if acfg.max_halo_budget > 0:
        knobs.append(Knob("halo_budget", "int", 0, acfg.max_halo_budget))
    return Space(knobs)


def _cfg_key(cfg: Dict) -> Tuple:
    out = []
    for k in sorted(cfg):
        v = cfg[k]
        out.append((k, round(float(v), 2)
                    if isinstance(v, (int, float, np.floating)) else v))
    return tuple(out)


@dataclass
class Episode:
    index: int
    config: Dict                    # decoded episode-space knobs
    metrics: Dict[str, float]       # MEASURED {throughput, memory, accuracy}
    reward: float
    cache_hit_rate: float
    steps: int
    predicted: Optional[Dict[str, float]] = None   # surrogate view, ep ≥ 1
    # host-runtime stamp (tuned_runtime_status()) for wall-clock episodes;
    # None when throughput came from the model (runtime can't skew Eqs. 2/4)
    tuned_runtime: Optional[Dict[str, bool]] = None


@dataclass
class AutotuneReport:
    episodes: List[Episode] = field(default_factory=list)
    baseline: Optional[Episode] = None
    best: Optional[Episode] = None
    best_feasible: bool = True      # False ⇒ EVERY measured episode broke
                                    # the memory limit; best = least-memory
    final_trainer: Optional[object] = None  # the trainer left running the
                                    # recommendation — differs from the
                                    # caller's when a `partitions` restart
                                    # rebuilt it (use this one afterwards)

    @property
    def baseline_metrics(self) -> Dict[str, float]:
        return self.baseline.metrics

    @property
    def final_metrics(self) -> Dict[str, float]:
        return self.best.metrics

    def changed_knobs(self) -> Dict[str, set]:
        """Knob → set of distinct values visited across episodes."""
        out: Dict[str, set] = {}
        for ep in self.episodes:
            for k, v in ep.config.items():
                out.setdefault(k, set()).add(
                    round(v, 4) if isinstance(v, float) else v)
        return {k: v for k, v in out.items() if len(v) > 1}

    def pareto_points(self) -> List[Episode]:
        """Non-dominated measured episodes (throughput↑, memory↓, acc↑)."""
        if not self.episodes:
            return []
        pts = np.array([[e.metrics["throughput"], -e.metrics["memory"],
                         e.metrics["accuracy"]] for e in self.episodes])
        return [self.episodes[i] for i in pareto_front(pts)]


class AutotuneController:
    """Drives PROPOSE → RECONFIGURE → MEASURE → FEEDBACK episodes over a
    live (trainer, pipeline) pair.  See the module docstring.  The PPO
    agent and every rebuilt trainer live on the trainer's ``device``."""

    def __init__(self, trainer, pipe, acfg: Optional[AutotuneConfig] = None):
        self.tr = trainer
        self.pipe = pipe
        self.acfg = acfg or trainer.cfg.autotune
        self.space = episode_space(self.acfg)
        self._knob_names = {k.name for k in self.space.knobs}
        self._restart_mgr = None        # lazy CheckpointManager (restart path)
        self.restarts = 0
        self.rng = np.random.default_rng(self.acfg.seed)
        self.surrogate = Surrogate(seed=self.acfg.seed,
                                   n_trees=self.acfg.surrogate_trees)
        self._X: List[np.ndarray] = []            # surrogate training set
        self._Y: Dict[str, List[float]] = {m: [] for m in
                                           ("throughput", "memory", "accuracy")}
        self._measured_keys: set = set()
        self.agent: Optional[PPOAgent] = None

    # -- objective -----------------------------------------------------------
    def reward(self, metrics: Dict[str, float]) -> float:
        if not self.feasible(metrics):
            return VIOLATION_REWARD
        a = self.acfg
        return (a.w_throughput * metrics["throughput"]
                - a.w_memory * metrics["memory"]
                + a.w_accuracy * metrics["accuracy"])

    def feasible(self, metrics: Dict[str, float]) -> bool:
        return metrics["memory"] <= self.acfg.memory_limit_bytes

    # -- surrogate pre-warm (analytic models → training points) --------------
    def prewarm(self, base_stats, base_acc: float):
        """Seed the surrogate from Eqs. 1-5 before any tuning episode.

        ``base_stats``: PipelineStats of the baseline episode — its measured
        per-stage times anchor the analytic throughput/memory predictions;
        ``accuracy_drop_model`` (Eq. 1) anchors accuracy."""
        st0 = base_stats.stage_times()
        base_hit = self._hit_model(self._current_config())
        for u in self.space.sample(self.rng, self.acfg.presample):
            cfg = self.space.decode(u)
            m = self._analytic_metrics(cfg, st0, base_hit, base_stats,
                                       base_acc)
            self._push_point(self.space.encode(cfg), m)
        self._refit()

    def _current_config(self) -> Dict:
        """The trainer's TRUE live knobs (cache_volume_mb may be 0 — a
        cache-less trainer; clamping to the space bounds happens only at
        encode time, see ``_encode``)."""
        c = self.tr.cfg
        cfg = {"bias_rate": c.bias_rate,
               "cache_volume_mb": (self.tr.cache.volume_mb
                                   if self.tr.cache is not None else 0.0),
               "parallel_mode": self.pipe.mode,
               "workers": self.pipe.workers_n}
        if "batch_size" in self._knob_names:
            cfg["batch_size"] = int(self.pipe.batch_size)
        if "sampling_device" in self._knob_names:
            cfg["sampling_device"] = str(self.pipe.sampling_device)
        if "partitions" in self._knob_names:
            cfg["partitions"] = int(c.partitions)
        if "halo_budget" in self._knob_names:
            cfg["halo_budget"] = int(getattr(c, "halo_budget", 0))
        return cfg

    def _encode(self, cfg: Dict) -> np.ndarray:
        """Encode for the surrogate, clamping out-of-space values (e.g. the
        cache-less baseline's Θ=0, or a seed workers count above
        ``max_workers``) onto the nearest space point."""
        clamped = dict(cfg)
        for k in self.space.knobs:
            if k.kind != "cat":
                clamped[k.name] = float(np.clip(cfg[k.name], k.lo, k.hi))
        return self.space.encode(clamped)

    def _hit_model(self, cfg: Dict) -> float:
        frac = self._cache_frac(cfg["cache_volume_mb"])
        return expected_hit_rate(frac, cfg["bias_rate"])

    def _cache_frac(self, volume_mb: float) -> float:
        g = self.tr.graph
        rows = volume_mb * 2**20 / (g.feat_dim * 4)
        return min(rows / g.num_nodes, 1.0)

    def _analytic_metrics(self, cfg: Dict, st0: StageTimes, base_hit: float,
                          base_stats, base_acc: float) -> Dict[str, float]:
        hit = self._hit_model(cfg)
        # batch generation is fetch-dominated: hits skip the host copy
        scale = (1.0 - HIT_SPEEDUP * hit) / max(1.0 - HIT_SPEEDUP * base_hit,
                                                1e-9)
        # device plane: resident rows gather in HBM instead of host memory
        if cfg.get("sampling_device") == "device":
            scale *= DEVICE_BATCH_SPEEDUP
        # per-step stage costs scale ~linearly with the mini-batch size
        cur_b = max(int(getattr(self.tr.cfg, "batch_size", 1)), 1)
        bscale = max(int(cfg.get("batch_size", cur_b)), 1) / cur_b
        st = StageTimes(st0.t_sample * bscale, st0.t_batch * scale * bscale,
                        st0.t_train * bscale)
        step_t = bottleneck_step_time(cfg["parallel_mode"], st,
                                      int(cfg["workers"]))
        # scale-out: p partitions each run the per-device pipeline, so
        # aggregate throughput AND fleet memory scale ~linearly with p,
        # while partition overlap η (Eq. 1) shrinks accuracy
        cur_p = max(int(getattr(self.tr.cfg, "partitions", 1)), 1)
        p = max(int(cfg.get("partitions", cur_p)), 1)
        budget = max(int(cfg.get("halo_budget",
                                 getattr(self.tr.cfg, "halo_budget", 0))), 0)
        mt = MemoryTerms(
            cache_bytes=cfg["cache_volume_mb"] * 2**20,
            batch_bytes=max(base_stats.peak_batch_bytes * bscale, 1),
            model_bytes=self.tr.model_bytes(base_stats),
            runtime_bytes=self.tr.runtime_bytes())
        mem = {"seq": memory_seq,
               "mode1": lambda t: memory_mode1(t, int(cfg["workers"])),
               "mode2": lambda t: memory_mode2(t, int(cfg["workers"])),
               }[cfg["parallel_mode"]](mt)
        # the halo budget widens each partition's effective overlap η (one
        # extra hop of boundary features) at the cost of replicated rows
        n_nodes = max(self.tr.full_graph.num_nodes, 1)
        eta = min(1.0, self.tr.eta * cur_p / p
                  + (budget / n_nodes if p > 1 else 0.0))
        halo_bytes = budget * self.tr.graph.feat_dim * 4 * (p if p > 1 else 0)
        drop = accuracy_drop_model(eta, cfg["bias_rate"],
                                   self.tr.graph.density(),
                                   self._cache_frac(cfg["cache_volume_mb"]))
        return {"throughput": p / max(step_t, 1e-9),
                "memory": float(mem) * p + halo_bytes,
                "accuracy": max(base_acc - drop, 0.0)}

    # -- surrogate bookkeeping ----------------------------------------------
    def _push_point(self, u: np.ndarray, metrics: Dict[str, float]):
        self._X.append(np.asarray(u, float))
        for m in self._Y:
            self._Y[m].append(float(metrics[m]))

    def _refit(self):
        X = np.stack(self._X)
        self.surrogate.fit(X, {m: np.asarray(v) for m, v in self._Y.items()})

    def _surrogate_eval(self, cfg: Dict) -> Dict[str, float]:
        pred = self.surrogate.predict(self.space.encode(cfg)[None])
        return {m: float(v[0]) for m, v in pred.items()}

    # -- PROPOSE -------------------------------------------------------------
    def propose(self) -> Tuple[Dict, Dict]:
        """PPO burst on the surrogate → best not-yet-measured config."""
        if self.agent is None:
            self.agent = PPOAgent(
                self.space, self._surrogate_eval,
                {"throughput": self.acfg.w_throughput,
                 "memory": self.acfg.w_memory,
                 "accuracy": self.acfg.w_accuracy},
                self.feasible,
                PPOConfig(updates=self.acfg.ppo_updates,
                          horizon=self.acfg.ppo_horizon,
                          seed=self.acfg.seed),
                device=self.tr.device)
        start = len(self.agent.history)
        self.agent.run(self.rng)
        burst = self.agent.history[start:]
        ranked = sorted(burst, key=lambda h: h[2], reverse=True)
        for cfg, pred, _ in ranked:
            if _cfg_key(cfg) not in self._measured_keys:
                return cfg, pred
        # every burst point already measured — jitter to a fresh one
        for _ in range(64):
            cfg = self.space.decode(self.space.sample(self.rng)[0])
            if _cfg_key(cfg) not in self._measured_keys:
                return cfg, self._surrogate_eval(cfg)
        return ranked[0][0], ranked[0][1]

    # -- MEASURE -------------------------------------------------------------
    def measure(self, index: int, cfg: Dict,
                predicted: Optional[Dict] = None) -> Episode:
        for c in getattr(self.tr, "caches", [self.tr.cache]):
            if c is not None:
                c.stats.reset()
        stats = self.pipe.run(max_steps=self.acfg.steps_per_episode)
        runtime = None
        if resolve_throughput_source(self.acfg) == "wallclock":
            # real multi-core host: threads overlap, the wall clock is the
            # truth (stats.steps counts per-partition mini-batches, so this
            # is already the aggregate fleet rate) — stamped with the host
            # runtime (tcmalloc/XLA flags) it was taken under
            throughput = stats.throughput_steps_per_s()
            runtime = tuned_runtime_status()
        else:
            st = stats.stage_times()
            step_t = bottleneck_step_time(self.pipe.mode, st,
                                          self.pipe.workers_n)
            # multi-partition pipelines report aggregate (fleet) throughput
            throughput = getattr(self.pipe, "scale_factor", 1) \
                / max(step_t, 1e-9)
        metrics = {
            "throughput": throughput,
            "memory": self.tr.modeled_memory(stats, mode=self.pipe.mode,
                                             workers=self.pipe.workers_n),
            "accuracy": self.tr.evaluate(max_batches=self.acfg.eval_batches),
        }
        ep = Episode(index=index, config=dict(cfg), metrics=metrics,
                     reward=self.reward(metrics),
                     cache_hit_rate=getattr(
                         self.tr, "cache_hit_rate",
                         self.tr.cache.stats.hit_rate
                         if self.tr.cache else 0.0),
                     steps=stats.steps, predicted=predicted,
                     tuned_runtime=runtime)
        self._measured_keys.add(_cfg_key(cfg))
        self._push_point(self._encode(cfg), metrics)        # FEEDBACK
        self._refit()
        return ep

    # -- RECONFIGURE: restart-capable path for the `partitions` knob ---------
    def _proposed_partitions(self, cfg: Dict) -> int:
        return max(int(cfg.get("partitions",
                               getattr(self.tr.cfg, "partitions", 1))), 1)

    def _restart(self, new_partitions: int,
                 halo_budget: Optional[int] = None):
        """checkpoint → rebuild trainer at the new partition count → restore.

        Params and optimizer state round-trip through train/checkpoint.py
        (the same machinery a real elastic restart uses), so training
        resumes exactly where it left off on the new topology.  A proposed
        ``halo_budget`` rides along into the rebuild so the subsequent
        live-swap pass finds it already applied (one slot build, not two)."""
        import tempfile
        from repro_torch.core.a3gnn import make_trainer
        from repro_torch.train.checkpoint import CheckpointManager
        if self._restart_mgr is None:
            d = self.acfg.restart_dir or tempfile.mkdtemp(
                prefix="a3gnn_restart_")
            self._restart_mgr = CheckpointManager(d, keep=1, async_save=False)
        old_p = max(int(getattr(self.tr.cfg, "partitions", 1)), 1)
        self.restarts += 1
        # the trainer's own save() records the full manifest extra
        # (partitions, global_steps, cache accounting) so progress counters
        # survive the migration
        self.tr.save(self._restart_mgr, step=self.restarts)
        self.pipe.shutdown()
        new_cfg = self.tr.cfg.replace(partitions=new_partitions)
        if halo_budget is not None:
            new_cfg = new_cfg.replace(halo_budget=max(int(halo_budget), 0))
        # keep the assigner the caller chose (a bfs/hash trainer must not
        # silently migrate to the locality default mid-autotune)
        method = getattr(getattr(self.tr, "plan", None), "method", "locality")
        new_tr = make_trainer(self.tr.full_graph, new_cfg, seed=self.tr.seed,
                              partition_method=method, device=self.tr.device)
        new_tr.restore(self._restart_mgr, step=self.restarts,
                       expect_partitions=old_p)
        # an attached FeatureStore follows the live trainer: the old
        # subscription is detached (updates must not route into the dead
        # topology) and the rebuilt trainer re-attaches to the same store
        store = getattr(self.tr, "feature_store", None)
        if store is not None:
            self.tr.detach_feature_store()
            new_tr.attach_feature_store(store)
        self.tr, self.pipe = new_tr, new_tr.make_pipeline()

    def _apply_config(self, cfg: Dict):
        """Full RECONFIGURE: restart if the partition count changed, then
        apply the live-swappable knobs to the (possibly new) trainer."""
        if self._proposed_partitions(cfg) != max(
                int(getattr(self.tr.cfg, "partitions", 1)), 1):
            self._restart(self._proposed_partitions(cfg),
                          halo_budget=cfg.get("halo_budget"))
        self.tr.apply_live_config(cfg, self.pipe)

    # -- main loop -----------------------------------------------------------
    def run(self) -> AutotuneReport:
        report = AutotuneReport()
        acfg = self.acfg
        if acfg.warmup_steps:
            self.pipe.run(mode="seq", max_steps=acfg.warmup_steps)
            self.pipe.reconfigure(mode=self.tr.cfg.parallel_mode)
        # episode 0: the fixed seed configuration = the baseline
        base_cfg = self._current_config()
        base = self.measure(0, base_cfg)
        report.episodes.append(base)
        report.baseline = base
        self.prewarm(self.pipe.stats, base.metrics["accuracy"])
        for e in range(1, acfg.episodes):
            cfg, pred = self.propose()
            self._apply_config(cfg)                         # RECONFIGURE
            report.episodes.append(self.measure(e, cfg, predicted=pred))
        feasible = [ep for ep in report.episodes
                    if self.feasible(ep.metrics)]
        if feasible:
            report.best = max(feasible, key=lambda ep: ep.reward)
        else:
            # nothing fit the budget — recommend the least-memory point and
            # flag it, rather than an arbitrary VIOLATION_REWARD tie-winner
            report.best = min(report.episodes,
                              key=lambda ep: ep.metrics["memory"])
            report.best_feasible = False
        # leave the trainer running the recommended configuration
        if _cfg_key(report.best.config) != _cfg_key(self._current_config()):
            self._apply_config(report.best.config)
        report.final_trainer = self.tr
        return report
