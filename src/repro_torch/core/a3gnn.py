"""A³GNN — the paper's framework, assembled.

``A3GNNTrainer`` wires together the feature cache, the locality-aware
(bias-rate γ) weighted-reservoir sampler, the multi-level parallel
pipeline and the GNN train step (unfused, or the all-hop fused step with
``GNNConfig.fused_gather_agg``), with parameters and optimizer state on
``device``; it reports the paper's three metrics (throughput, memory
footprint, accuracy).

Baseline adapters reproduce the comparison systems *as configurations*:
  * ``pyg_like``     — CPU sampling, no feature cache, sequential loop
  * ``quiver_like``  — device-biased static hotness cache, workers, no
    sampling/caching coordination (γ=1)

Checkpoint/restore rides ``train/checkpoint.py`` and streamed feature
updates ``graph/storage.py``'s ``FeatureStreamConsumer``; ``make_trainer``
builds the multi-partition trainer (core/multipart.py) for
``partitions > 1``.  ``apply_live_config`` and ``fit_autotuned`` are the
online auto-tuner's hooks (core/autotune/controller.py).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.gnn import GNNConfig
from repro_torch.core.cache import FeatureCache
from repro_torch.core.locality import accuracy_drop_model, bias_weight_fn
from repro_torch.core.perf_model import (MemoryTerms, bottleneck_step_time,
                                         memory_mode1, memory_mode2,
                                         memory_seq)
from repro_torch.core.pipeline import Pipeline, PipelineStats
from repro_torch.core.sampling import NeighborSampler, seed_loader
from repro_torch.graph.batch import (batch_device_arrays, compute_level_caps,
                                     generate_batch)
from repro_torch.graph.partition import overlap_ratio, partition
from repro_torch.graph.storage import FeatureStreamConsumer, Graph
from repro_torch.models.gnn import (decls_gnn, make_eval_fn, make_train_step,
                                    make_train_step_allfused)
from repro_torch.models.params import init_params, param_bytes
from repro_torch.train.checkpoint import TrainerCheckpointMixin
from repro_torch.train.optimizer import make_adamw

RUNTIME_BYTES = 16 * 2**20        # fixed per-worker runtime context (Eq. 3)


@dataclass
class RunResult:
    throughput_steps_s: float     # wall clock
    throughput_epochs_s: float
    modeled_steps_s: float        # Eqs. 2/4 from measured stage times
    modeled_epochs_s: float
    memory_bytes: float           # modeled peak (Eqs. 3/5)
    test_acc: float
    cache_hit_rate: float
    stats: PipelineStats
    steps_per_epoch: int

    def metrics(self) -> Dict[str, float]:
        return {"throughput": self.modeled_epochs_s,
                "memory": self.memory_bytes,
                "accuracy": self.test_acc}


def apply_baseline(cfg: GNNConfig, baseline: Optional[str]) -> GNNConfig:
    if baseline in (None, "a3gnn"):
        return cfg
    if baseline == "pyg_like":
        return cfg.replace(bias_rate=1.0, cache_volume_mb=0.0,
                           parallel_mode="seq", sampling_device="cpu",
                           workers=1)
    if baseline == "quiver_like":
        return cfg.replace(bias_rate=1.0, cache_policy="static",
                           parallel_mode="mode1", sampling_device="device",
                           workers=2)
    raise ValueError(baseline)


class A3GNNTrainer(TrainerCheckpointMixin, FeatureStreamConsumer):
    def __init__(self, graph: Graph, cfg: GNNConfig, seed: int = 0,
                 device="cuda"):
        self.full_graph = graph
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        parts = partition(graph, cfg.partitions)
        self.graph = parts[0]                       # worker 0's partition
        self.eta = overlap_ratio(self.graph, graph)
        self.cache = (FeatureCache(self.graph, cfg.cache_volume_mb,
                                   cfg.cache_policy)
                      if cfg.cache_volume_mb > 0 else None)
        self.weight_fn = (bias_weight_fn(self.cache, cfg.bias_rate)
                          if (self.cache is not None and cfg.bias_rate > 1.0)
                          else None)
        self.decls = decls_gnn(cfg)
        self.params = init_params(self.decls,
                                  torch.Generator().manual_seed(seed),
                                  self.device)
        self.opt = make_adamw()
        self.opt_state = self.opt.init(self.params)
        self._step = make_train_step(cfg, self.opt)
        self._step_allfused = (make_train_step_allfused(cfg, self.opt)
                               if cfg.fused_gather_agg else None)
        self._eval = make_eval_fn(cfg)
        # host seconds of each part of every fused train stage: padding to
        # the level caps, the plane's encoded read, the copies to ``device``,
        # and the step up to the loss read.  Each part ends in a blocking
        # copy or the loss read, so the card's work lies in the part that
        # issued it.
        self.fused_parts: Dict[str, List[float]] = {
            "pad": [], "encode": [], "copy": [], "step": []}

    def _to_device(self, a):
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    # streaming feature updates — attach/detach from FeatureStreamConsumer
    # (graph/storage.py); single-partition routing: refresh resident rows
    # ------------------------------------------------------------------
    def _check_feature_store_target(self):
        if self.graph is not self.full_graph:
            raise ValueError("attach_feature_store needs the undivided "
                             "graph (partitions=1); use "
                             "MultiPartitionTrainer for partition fleets")

    def _on_feature_update(self, ids, rows):
        # the store already wrote the host rows; pull resident copies
        # (device mirrors re-sync off FeatureCache.version), so the
        # trainer — and every serving engine sharing its plane — observes
        # the drift
        del rows
        if self.cache is not None:
            self.cache.refresh_rows(ids)

    # ------------------------------------------------------------------
    def _train_fn(self, mb, plane=None):
        if (self._step_allfused is not None and plane is not None
                and mb.features is None and mb.blocks):
            # all-hop fused path: level-capped buffers, the input hop
            # resolved at step time through the plane (encoded slots + miss
            # sideband — no feature tensor rides the batch)
            t0 = time.perf_counter()
            caps = compute_level_caps(len(mb.seeds), self.cfg.fanout,
                                      self.graph.num_nodes)
            arrays = batch_device_arrays(mb, level_caps=caps)
            t1 = time.perf_counter()
            enc0, aux0, table = plane.fused_inputs(mb.input_ids,
                                                   arrays["pads"][0])
            t2 = time.perf_counter()
            inputs = (enc0.to(self.device), aux0.to(self.device),
                      table.to(self.device),
                      [self._to_device(i) for i in arrays["neigh_idxs"]],
                      self._to_device(arrays["labels"]))
            t3 = time.perf_counter()
            self.params, self.opt_state, loss, acc = self._step_allfused(
                self.params, self.opt_state, *inputs)
            loss = float(loss)
            t4 = time.perf_counter()
            for part, dt in zip(self.fused_parts,
                                (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                self.fused_parts[part].append(dt)
        else:
            arrays = batch_device_arrays(mb)
            self.params, self.opt_state, loss, acc = self._step(
                self.params, self.opt_state,
                self._to_device(arrays["features"]),
                [self._to_device(i) for i in arrays["neigh_idxs"]],
                self._to_device(arrays["labels"]))
        return float(loss), float(acc)

    # ------------------------------------------------------------------
    def run_epochs(self, epochs: int = 1,
                   max_steps_per_epoch: Optional[int] = None,
                   mode: Optional[str] = None,
                   fail_worker: Optional[int] = None,
                   warmup_steps: int = 0,
                   simulate: bool = False) -> RunResult:
        """``simulate=True`` executes the stages sequentially (uncontended
        stage-time measurement) while the modeled throughput uses the
        CONFIGURED parallel mode via Eqs. 2/4."""
        target_mode = mode or self.cfg.parallel_mode
        exec_mode = "seq" if simulate else target_mode
        pipe = self.make_pipeline()
        if warmup_steps:
            # first-call set-up (and FIFO cache warm) outside the timing
            pipe.run(mode="seq", max_steps=warmup_steps)
            if self.cache is not None:
                self.cache.stats.reset()
        agg: Optional[PipelineStats] = None
        try:
            agg = self._run_pipe_epochs(pipe, exec_mode, epochs,
                                        max_steps_per_epoch, fail_worker)
        finally:
            pipe.shutdown()
        steps_per_epoch = max(
            int(self.graph.train_mask.sum()) // self.cfg.batch_size, 1)
        sps = agg.throughput_steps_per_s()
        mem = self.modeled_memory(agg)
        step_t = bottleneck_step_time(target_mode, agg.stage_times(),
                                      self.cfg.workers)
        msps = 1.0 / max(step_t, 1e-9)
        return RunResult(
            throughput_steps_s=sps,
            throughput_epochs_s=sps / steps_per_epoch,
            modeled_steps_s=msps,
            modeled_epochs_s=msps / steps_per_epoch,
            memory_bytes=mem,
            test_acc=self.evaluate(),
            cache_hit_rate=self.cache_hit_rate,
            stats=agg, steps_per_epoch=steps_per_epoch)

    @staticmethod
    def _run_pipe_epochs(pipe: Pipeline, exec_mode: str, epochs: int,
                         max_steps_per_epoch: Optional[int],
                         fail_worker: Optional[int]) -> PipelineStats:
        agg: Optional[PipelineStats] = None
        for ep in range(epochs):
            stats = pipe.run(mode=exec_mode, max_steps=max_steps_per_epoch,
                             fail_worker=fail_worker if ep == 0 else None)
            if agg is None:
                agg = stats
            else:
                agg.steps += stats.steps
                agg.t_sample += stats.t_sample
                agg.t_batch += stats.t_batch
                agg.t_train += stats.t_train
                agg.t_wall += stats.t_wall
                agg.losses += stats.losses
                agg.accs += stats.accs
                agg.reissued += stats.reissued
                agg.peak_batch_bytes = max(agg.peak_batch_bytes,
                                           stats.peak_batch_bytes)
        return agg

    # ------------------------------------------------------------------
    def model_bytes(self, stats: PipelineStats) -> float:
        # |M| of Eq. (3) = params+grads+opt + ACTIVATIONS; activations scale
        # with the deduplicated input-node count (∝ batch bytes)
        act_factor = max(3.0 * self.cfg.hidden * self.cfg.num_layers
                         / max(self.cfg.feat_dim, 1), 1.0)
        act_bytes = stats.peak_batch_bytes * act_factor
        return 3 * param_bytes(self.decls) + act_bytes

    @staticmethod
    def runtime_bytes() -> float:
        return RUNTIME_BYTES

    def modeled_memory(self, stats: PipelineStats,
                       mode: Optional[str] = None,
                       workers: Optional[int] = None) -> float:
        mt = MemoryTerms(
            cache_bytes=self.cache.volume_bytes() if self.cache else 0.0,
            batch_bytes=max(stats.peak_batch_bytes, 1),
            model_bytes=self.model_bytes(stats),
            runtime_bytes=RUNTIME_BYTES)
        mode = mode or self.cfg.parallel_mode
        workers = workers if workers is not None else self.cfg.workers
        if mode == "mode1":
            return memory_mode1(mt, workers)
        if mode == "mode2":
            return memory_mode2(mt, workers)
        return memory_seq(mt)

    # ------------------------------------------------------------------
    @property
    def caches(self):
        """Uniform per-partition cache view (single partition: one entry)."""
        return [self.cache]

    @property
    def cache_hit_rate(self) -> float:
        return self.cache.stats.hit_rate if self.cache is not None else 0.0

    def make_pipeline(self) -> Pipeline:
        return Pipeline(self.graph, self.cfg, self._train_fn,
                        cache=self.cache, weight_fn=self.weight_fn,
                        seed=self.seed, device=self.device)

    # weight hand-off to serving replicas: the step returns new tensors and
    # never writes into the old ones, so an export is a consistent snapshot
    def get_weights(self) -> Dict:
        return {"params": self.params}

    def set_weights(self, weights: Dict):
        self.params = weights["params"]

    # checkpoint/restart interface: TrainerCheckpointMixin provides
    # state_dict/load_state_dict/save/restore (+ the partition-count guard)
    def checkpoint_extra(self) -> Dict:
        return {**super().checkpoint_extra(),
                "cache_stats": [dataclasses.asdict(self.cache.stats)
                                if self.cache is not None else None]}

    # ------------------------------------------------------------------
    def apply_live_config(self, knobs: Dict, pipe: Optional[Pipeline] = None):
        """Episode-boundary reconfiguration (autotune controller).

        Applies any of (bias_rate γ, cache_volume_mb Θ, parallel_mode,
        workers, batch_size, sampling_device) to the live trainer: the
        cache is resized with its hit/miss accounting intact, the sampler
        bias weight function is rebuilt for the new γ, and — when ``pipe``
        is given — the executor drains and swaps mode/workers/feature-plane
        backend without dropping a batch.  ``halo_budget`` is recorded but
        inert at one partition (no cut edges to recover; core/multipart.py
        implements the real swap)."""
        updates = {k: knobs[k] for k in ("bias_rate", "cache_volume_mb",
                                         "parallel_mode", "workers",
                                         "batch_size", "sampling_device")
                   if k in knobs}
        if "halo_budget" in knobs:
            self.cfg = self.cfg.replace(halo_budget=int(knobs["halo_budget"]))
        if "workers" in updates:
            updates["workers"] = int(updates["workers"])
        if "batch_size" in updates:
            updates["batch_size"] = int(updates["batch_size"])
        self.cfg = self.cfg.replace(**updates)
        if "cache_volume_mb" in updates:
            vol = float(updates["cache_volume_mb"])
            if vol <= 0:
                self.cache = None
            elif self.cache is None:
                self.cache = FeatureCache(self.graph, vol,
                                          self.cfg.cache_policy)
            else:
                self.cache.resize(vol)
        if "cache_volume_mb" in updates or "bias_rate" in updates:
            self.weight_fn = (bias_weight_fn(self.cache, self.cfg.bias_rate)
                              if (self.cache is not None
                                  and self.cfg.bias_rate > 1.0) else None)
        if pipe is not None:
            pipe.reconfigure(mode=updates.get("parallel_mode"),
                             workers=updates.get("workers"),
                             cache=self.cache, weight_fn=self.weight_fn,
                             batch_size=updates.get("batch_size"),
                             sampling_device=updates.get("sampling_device"))

    # ------------------------------------------------------------------
    def fit_autotuned(self, autotune=None, seed: Optional[int] = None):
        """Train under the online auto-tuner (paper §III-C, Algo. 3 live).

        Runs ``autotune.episodes`` PROPOSE → RECONFIGURE → MEASURE →
        FEEDBACK episodes (see core/autotune/controller.py) on a persistent
        pipeline and returns the ``AutotuneReport`` — measured Pareto
        points, per-episode configs/metrics, and the recommendation the
        trainer is left running."""
        from repro_torch.core.autotune.controller import fit_autotuned
        return fit_autotuned(self, autotune, seed)

    # ------------------------------------------------------------------
    def evaluate(self, max_batches: int = 8) -> float:
        sampler = NeighborSampler(self.graph, self.cfg.fanout, weight_fn=None,
                                  seed=self.seed + 12345)
        accs = []
        for i, seeds in enumerate(seed_loader(self.graph, self.cfg.batch_size,
                                              self.seed,
                                              mask=self.graph.test_mask)):
            if i >= max_batches:
                break
            mb = generate_batch(sampler.sample(seeds), None, self.graph)
            arrays = batch_device_arrays(mb)
            accs.append(float(self._eval(
                self.params, self._to_device(arrays["features"]),
                [self._to_device(a) for a in arrays["neigh_idxs"]],
                self._to_device(arrays["labels"]))))
        return float(np.mean(accs)) if accs else 0.0

    def predicted_accuracy_drop(self) -> float:
        cache_frac = ((self.cache.capacity / self.graph.num_nodes)
                      if self.cache else 0.0)
        return accuracy_drop_model(self.eta, self.cfg.bias_rate,
                                   self.graph.density(), cache_frac)


def make_trainer(graph: Graph, cfg: GNNConfig, seed: int = 0,
                 partition_method: str = "locality", device="cuda"):
    """Trainer factory: the multi-partition scale-out trainer when
    ``cfg.partitions > 1``, the classic single-partition ``A3GNNTrainer``
    otherwise.  Both share the checkpoint/restore interface."""
    if cfg.partitions > 1:
        from repro_torch.core.multipart import MultiPartitionTrainer
        return MultiPartitionTrainer(graph, cfg, seed=seed,
                                     method=partition_method, device=device)
    return A3GNNTrainer(graph, cfg, seed=seed, device=device)


def run_config(graph: Graph, cfg: GNNConfig, baseline: Optional[str] = None,
               epochs: int = 1, max_steps: Optional[int] = 30,
               seed: int = 0, warmup_steps: int = 0,
               simulate: bool = False, device="cuda") -> RunResult:
    cfg = apply_baseline(cfg, baseline)
    tr = A3GNNTrainer(graph, cfg, seed=seed, device=device)
    return tr.run_epochs(epochs, max_steps_per_epoch=max_steps,
                         warmup_steps=warmup_steps, simulate=simulate)
