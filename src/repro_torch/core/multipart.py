"""Multi-partition data-parallel GNN training on the distributed substrate.

The paper's headline result is scale-OUT: many affordable devices, each
training on its own graph partition with no remote feature access, beat a
few expensive ones.  ``MultiPartitionTrainer`` reproduces that topology on
the existing substrate:

  * ``graph/partition.py`` assigns nodes with the locality-aware method
    (fewest cross-partition halo nodes — every cut edge is a feature the
    device would otherwise fetch remotely);
  * each partition owns a private ``FeatureCache`` + reconfigurable
    ``Pipeline`` whose feature plane lives on the trainer's ``device``
    (sampling bias γ, cache volume Θ, parallel mode all apply per
    partition, exactly as on a real device);
  * gradients synchronize through ``distributed/collectives.grad_allreduce``
    under a mesh from ``launch/mesh.make_partition_mesh``: the
    host-simulated mesh (every partition in this process, on the
    trainer's one device) or a ``GroupMesh`` (one process per partition,
    a ``torch.distributed`` group; this process holds partition ``rank``
    only, see below);
  * with ``cfg.halo_budget > 0`` each partition's subgraph is augmented
    with its top-k boundary nodes (``PartitionPlan.halo_sets``) and their
    feature rows arrive through ``distributed/collectives.halo_all_to_all``
    — sampled batches reach one hop across the cut, and per-partition
    ``HaloStats`` count how many batch input nodes the halo served
    (checkpointed next to the cache hit accounting);
  * checkpoint/restore rides ``train/checkpoint.py`` (partition topology +
    per-partition cache hit accounting in the manifest) and restart/straggler
    handling rides ``train/fault_tolerance.py`` (``fit_supervised``);
  * streaming graphs: ``attach_feature_store`` subscribes the fleet to a
    ``graph/storage.py`` ``FeatureStore`` — owned-row updates land in the
    owning partition's feature plane immediately, stale halo copies are
    recovered by a bounded periodic halo re-fill
    (``cfg.halo_refresh_interval`` / ``refresh_halo_features``).

Interface-compatible with ``A3GNNTrainer`` where the autotune controller
needs it, so the episode space can tune ``partitions`` through the
checkpoint → rebuild → restore restart path.

Under a ``GroupMesh`` every process builds the whole plan
(``plan_partitions`` is deterministic) and one slot, its rank's, with
that partition's seed; params and ``opt_state`` stay equal on every
process (the same mean, the same update).  Whatever the host-simulated
trainer reports over all partitions (evaluation, cache and halo
statistics, modeled memory, the pipeline's merged stats, the checkpoint's
manifest) is gathered over the group in partition order, so every
process reports the same as the host-simulated trainer: those reads are
collectives, and every process makes them in the same order.  Rank 0
writes the checkpoints (``GroupCheckpointManager``).

The live operations run over a group as the JAX package runs them over
its real mesh.  ``set_halo_budget`` and ``rebalance_partitions`` derive
the new plan on every process (``with_halo_budget`` and
``incremental_rebalance`` are deterministic), rebuild this process's slot
and refill its halo rows through ``halo_all_to_all``.  The contract of a
streaming graph: every process receives the same topology edits
(``Graph.add_edges``) and the same ``FeatureStore.update_rows`` stream, in
the same order, between the same global steps — each process holds its
own copy of the full graph.  An update fills the owning process's plane;
``_halo_dirty`` follows from the plan, so every process agrees on it and
the periodic ``refresh_halo_features`` is a collective made at the same
global step.  Before a rebalance the processes gather their topology
version and the digests of their adjacency and plan, and with a drift
trigger (``cfg.rebalance_drift``) their version and decision each global
step: any disagreement raises, rather than train on diverged plans.  The
auto-tuner (``fit_autotuned``) runs one controller a process, in lockstep
(core/autotune/controller.py); a group spawned for more processes than
partitions holds ``IdleRank``s past the partition count
(``make_rank_trainer``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.gnn import GNNConfig
from repro_torch.core.a3gnn import A3GNNTrainer, RunResult
from repro_torch.core.cache import FeatureCache
from repro_torch.core.locality import accuracy_drop_model, bias_weight_fn
from repro_torch.core.perf_model import (MemoryTerms, bottleneck_step_time,
                                         memory_mode1, memory_mode2,
                                         memory_seq)
from repro_torch.core.pipeline import Pipeline, PipelineStats
from repro_torch.core.sampling import NeighborSampler, seed_loader
from repro_torch.distributed.collectives import (agree, all_gather_objects,
                                                 grad_allreduce,
                                                 halo_all_to_all)
from repro_torch.graph.batch import (batch_device_arrays, compute_level_caps,
                                     generate_batch)
from repro_torch.graph.partition import (PartitionPlan, RebalanceResult,
                                         assignment_cut_fraction,
                                         incremental_rebalance,
                                         plan_partitions)
from repro_torch.graph.storage import FeatureStreamConsumer, Graph
from repro_torch.launch.mesh import (GroupMesh, make_partition_mesh,
                                     world_mesh)
from repro_torch.models.gnn import (decls_gnn, make_apply_fn, make_eval_fn,
                                    make_grad_fn, make_grad_fn_allfused)
from repro_torch.models.params import init_params, param_bytes
from repro_torch.train.checkpoint import (CheckpointManager,
                                          GroupCheckpointManager,
                                          TrainerCheckpointMixin)
from repro_torch.train.fault_tolerance import (SupervisorReport,
                                               TrainSupervisor)
from repro_torch.train.optimizer import make_adamw

RUNTIME_BYTES = 16 * 2**20        # fixed per-worker runtime context (Eq. 3)


@dataclass
class HaloStats:
    """Per-partition halo accounting: how many batch input nodes fell in
    the halo region (local id ≥ owned count) — the information the bounded
    exchange recovered vs. the drop-cut-edges setting."""
    halo_hits: int = 0          # input nodes served from the halo region
    inputs: int = 0             # total batch input nodes seen
    batches: int = 0

    @property
    def hit_rate(self) -> float:
        return self.halo_hits / self.inputs if self.inputs else 0.0

    def reset(self):
        self.halo_hits = self.inputs = self.batches = 0


@dataclass
class PartitionSlot:
    """One partition's private training state (the per-device view)."""
    index: int
    graph: Graph
    eta: float
    n_owned: int = 0            # local ids ≥ n_owned are halo rows
    cache: Optional[FeatureCache] = None
    weight_fn: Optional[Callable] = None
    pipe: Optional[Pipeline] = None
    pending_grads: Optional[Dict] = None
    halo_stats: HaloStats = field(default_factory=HaloStats)
    _seed_iter: Optional[object] = None
    _epoch: int = 0


class MultiPipeline:
    """Pipeline-shaped view over all partition pipelines.

    Exposes the subset of the ``Pipeline`` contract its callers use
    (``run`` / ``reconfigure`` / ``begin_stats`` / ``stats`` / ``mode`` /
    ``workers_n`` / ``shutdown``); each ``run`` window executes
    gradient-synchronized GLOBAL steps, so ``stats.steps`` counts
    per-partition mini-batches (``scale_factor`` × global steps).
    """

    def __init__(self, trainer: "MultiPartitionTrainer"):
        self.tr = trainer
        self.stats = PipelineStats()

    @property
    def pipes(self) -> List[Pipeline]:
        return [s.pipe for s in self.tr.slots]

    @property
    def mode(self) -> str:
        return self.pipes[0].mode

    @property
    def workers_n(self) -> int:
        return self.pipes[0].workers_n

    @property
    def batch_size(self) -> int:
        return self.pipes[0].batch_size

    @property
    def sampling_device(self) -> str:
        return self.pipes[0].sampling_device

    @property
    def scale_factor(self) -> int:
        return self.tr.plan.parts

    def begin_stats(self) -> PipelineStats:
        self.stats = PipelineStats()
        for p in self.pipes:
            p.begin_stats()
        return self.stats

    def reconfigure(self, mode: Optional[str] = None,
                    workers: Optional[int] = None, cache=None, weight_fn=None,
                    batch_size: Optional[int] = None,
                    sampling_device: Optional[str] = None):
        """Drain + swap each partition pipeline.  Per-partition cache and
        bias always re-sync from the slots (they are per-partition state —
        the ``cache``/``weight_fn`` arguments of the single-pipeline
        contract are ignored here)."""
        del cache, weight_fn
        for slot in self.tr.slots:
            slot.pipe.reconfigure(mode=mode, workers=workers,
                                  cache=slot.cache, weight_fn=slot.weight_fn,
                                  batch_size=batch_size,
                                  sampling_device=sampling_device)

    def drain(self):
        for p in self.pipes:
            p.drain()

    def shutdown(self):
        for p in self.pipes:
            p.shutdown()

    def run(self, mode: Optional[str] = None, max_steps: Optional[int] = None,
            fail_worker: Optional[int] = None) -> PipelineStats:
        """Run ``max_steps`` gradient-synchronized global steps."""
        if mode is not None and mode != self.mode:
            self.reconfigure(mode=mode)
        tr = self.tr
        n = max_steps if max_steps is not None else tr.steps_per_epoch()
        stats = self.begin_stats()
        # submit every seed batch upfront: under mode1/mode2 the worker
        # pools prefetch ahead of the synchronized consumer, as on hardware
        for slot in tr.slots:
            seeds = [tr._next_seeds(slot) for _ in range(n)]
            slot.pipe.submit(seeds, fail_worker=(fail_worker
                                                 if slot.index == 0 else None))
        t0 = time.perf_counter()
        for _ in range(n):
            tr._consume_synced_step()
        stats.t_wall = time.perf_counter() - t0
        self._aggregate(stats)
        if fail_worker is not None:
            self.pipes[0]._stop_pool()      # injected-failure pool is poisoned
        return stats

    def _aggregate(self, agg: PipelineStats):
        """Merge every partition's stats into ``agg``, in partition order
        (gathered over a group)."""
        for st in self.tr._over_parts(lambda s: s.pipe.stats):
            agg.steps += st.steps
            agg.t_sample += st.t_sample
            agg.t_batch += st.t_batch
            agg.t_train += st.t_train
            agg.losses += st.losses
            agg.accs += st.accs
            agg.reissued += st.reissued
            agg.peak_batch_bytes = max(agg.peak_batch_bytes,
                                       st.peak_batch_bytes)
            agg.queue_peak = max(agg.queue_peak, st.queue_peak)


class MultiPartitionTrainer(TrainerCheckpointMixin, FeatureStreamConsumer):
    """Data-parallel A³GNN over ``cfg.partitions`` graph partitions.

    Shared (params, opt_state) on ``device``; per-partition (subgraph,
    cache, sampler bias, pipeline, feature plane on ``device``).
    ``batch_size`` is per partition — the effective global batch is
    ``partitions × batch_size``, matching the paper's fixed-per-device
    batching."""

    def __init__(self, graph: Graph, cfg: GNNConfig, seed: int = 0,
                 method: str = "locality", device="cuda"):
        if cfg.partitions < 1:
            raise ValueError(f"partitions must be ≥ 1, got {cfg.partitions}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MultiPartitionTrainer(device='cuda') needs a "
                               "CUDA device; pass device='cpu' to train on "
                               "the host")
        self.full_graph = graph
        self.cfg = cfg
        self.seed = seed
        t0 = time.perf_counter()
        self.plan: PartitionPlan = plan_partitions(graph, cfg.partitions,
                                                   method, seed,
                                                   halo_budget=cfg.halo_budget)
        self.plan_seconds = time.perf_counter() - t0    # host numpy
        self.mesh = make_partition_mesh(self.plan.parts, self.device)
        self._allreduce = grad_allreduce(self.mesh)
        self._halo_exchange = halo_all_to_all(self.mesh)
        self.decls = decls_gnn(cfg)
        self.params = init_params(self.decls,
                                  torch.Generator().manual_seed(seed),
                                  self.device)
        self.opt = make_adamw()
        self.opt_state = self.opt.init(self.params)
        self._grad = make_grad_fn(cfg)
        # one all-fused grad fn shared by every slot (its call counter
        # counts every partition's fused gradients)
        self._grad_allfused = (make_grad_fn_allfused(cfg)
                               if cfg.fused_gather_agg else None)
        self._apply = make_apply_fn(cfg, self.opt)
        self._eval = make_eval_fn(cfg)
        self.slots = self._make_slots()
        self.halo_exchange_bytes = self._fill_halo_features()
        self.eta = float(np.mean(self.plan.etas(graph)))
        self.global_steps = 0
        # streaming-update state (attach_feature_store)
        self.halo_refreshes = 0
        self._halo_dirty = False
        # dynamic-topology state: cut fraction at plan build (the drift
        # baseline) + rebalance accounting
        self._plan_cut_fraction = assignment_cut_fraction(graph,
                                                          self.plan.owner)
        self.rebalances = 0
        self.last_rebalance: Optional[RebalanceResult] = None

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    @property
    def _group(self) -> bool:
        return isinstance(self.mesh, GroupMesh)

    def _make_slots(self) -> List[PartitionSlot]:
        """The partitions this process holds: all of them on a
        host-simulated mesh, its rank's on a ``GroupMesh``."""
        parts = ([self.mesh.rank] if self._group
                 else range(self.plan.parts))
        return [self._make_slot(p, self.plan.subgraphs[p]) for p in parts]

    def _over_parts(self, fn: Callable[[PartitionSlot], object]) -> List:
        """``fn(slot)`` for every partition, in partition order; over a
        group, each process's values gathered (a collective)."""
        return [v for vals in all_gather_objects(
            self.mesh, [fn(s) for s in self.slots]) for v in vals]

    def fleet_fingerprint(self):
        """(graph topology version, plan topology version, digest of the
        current adjacency and of the plan's owner map): what every process
        of a group must hold alike before a rebalance."""
        h = hashlib.blake2b(digest_size=16)
        for a in (*self.full_graph.adj(), self.plan.owner):
            h.update(np.ascontiguousarray(a).tobytes())
        return (int(self.full_graph.topology_version),
                int(self.plan.topology_version), h.hexdigest())

    # ------------------------------------------------------------------
    def _fill_halo_features(self) -> int:
        """Move the budgeted boundary feature rows through the partition
        mesh (``halo_all_to_all``): each subgraph's halo rows — zeroed by
        the plan, owned by another partition — are filled from the owner's
        feature store, THROUGH each partition's feature plane
        (``FeaturePlane.fill_rows``), so cache-resident copies update and
        device mirrors re-sync no matter which backend serves the next
        fetch.  Returns the exchange volume in bytes."""
        if self.plan.halo_rows == 0:
            return 0
        owned = [sub.features[:len(ns)] for sub, ns in
                 zip(self.plan.subgraphs, self.plan.node_sets)]
        halo_feats, volume = self._halo_exchange(self.plan, owned)
        for slot in self.slots:
            rows, n = halo_feats[slot.index], slot.n_owned
            if len(rows):
                slot.pipe.plane.fill_rows(np.arange(n, n + len(rows)), rows)
        return int(volume)

    # ------------------------------------------------------------------
    # streaming feature updates — attach/detach from FeatureStreamConsumer
    # (graph/storage.py); fleet routing: owner's plane now, halo later
    # ------------------------------------------------------------------
    def _owned_local(self) -> np.ndarray:
        """(N,) local id of each node WITHIN its owning partition — the
        plan's shared ownership-lookup index (``PartitionPlan.local_ids``)."""
        return self.plan.local_ids()

    def _local_id(self, p: int, node: int) -> int:
        """Local id of global ``node`` in partition p's subgraph (owned
        prefix or halo tail), -1 if absent.  Debug/test helper — the
        update path routes vectorized through ``plan.owner``."""
        if int(self.plan.owner[node]) == p:
            return int(self._owned_local()[node])
        if self.plan.halo_sets:
            pos = np.where(self.plan.halo_sets[p] == node)[0]
            if len(pos):
                return len(self.plan.node_sets[p]) + int(pos[0])
        return -1

    def _on_feature_update(self, ids: np.ndarray, rows: np.ndarray):
        """FeatureStore subscriber: updates are routed immediately to the
        OWNING partition's feature plane (cache-resident copies update,
        device mirrors invalidate); halo copies of updated rows on OTHER
        partitions only go stale — re-filling them is the bounded periodic
        exchange's job (``cfg.halo_refresh_interval`` /
        ``refresh_halo_features``): streaming updates must not turn every
        row write into cross-partition traffic.  Over a group only the
        slot this process holds is filled: the owner's plane, whose
        subgraph rows are what the exchange sends."""
        ids = np.asarray(ids, dtype=np.int64)
        owners = self.plan.owner[ids]
        local = self._owned_local()[ids]
        for slot in self.slots:
            mine = owners == slot.index
            if mine.any():
                slot.pipe.plane.fill_rows(local[mine], rows[mine])
        if not self._halo_dirty:
            for hs in self.plan.halo_sets:
                if len(hs) and np.isin(ids, hs).any():
                    self._halo_dirty = True
                    break

    def refresh_halo_features(self) -> int:
        """Re-run the bounded halo exchange over the CURRENT budget: the
        same affinity-ranked rows move again through the mesh, through
        each partition's feature plane (mirror invalidation included), so
        halo copies catch up with streamed feature drift.  Returns the
        exchanged volume in bytes (0 with no halo).  A collective over a
        group: every process calls it."""
        volume = self._fill_halo_features()
        self.halo_refreshes += 1
        self._halo_dirty = False
        return volume

    def _maybe_refresh_halo(self):
        every = getattr(self.cfg, "halo_refresh_interval", 0)
        if (every > 0 and self._halo_dirty
                and self.global_steps % every == 0):
            self.refresh_halo_features()

    def _make_slot(self, p: int, sub: Graph) -> PartitionSlot:
        cfg = self.cfg
        cache = (FeatureCache(sub, cfg.cache_volume_mb, cfg.cache_policy)
                 if cfg.cache_volume_mb > 0 else None)
        weight_fn = (bias_weight_fn(cache, cfg.bias_rate)
                     if (cache is not None and cfg.bias_rate > 1.0) else None)
        n_owned = len(self.plan.node_sets[p])
        # Eq. 1 overlap counts OWNED nodes only — halo leaves are borrowed
        # features, not partition membership
        slot = PartitionSlot(index=p, graph=sub,
                             eta=n_owned / max(self.full_graph.num_nodes, 1),
                             n_owned=n_owned,
                             cache=cache, weight_fn=weight_fn)
        slot.pipe = Pipeline(sub, cfg, self._slot_train_fn(slot), cache=cache,
                             weight_fn=weight_fn, seed=self.seed + p,
                             device=self.device)
        return slot

    def _slot_train_fn(self, slot: PartitionSlot):
        """Per-partition "train" = local gradient computation; the shared
        update is applied after the cross-partition all-reduce."""
        def fn(mb, plane=None):
            hs = slot.halo_stats
            hs.halo_hits += int((mb.input_ids >= slot.n_owned).sum())
            hs.inputs += len(mb.input_ids)
            hs.batches += 1
            dev = self._to_device
            if (self._grad_allfused is not None and plane is not None
                    and mb.features is None and mb.blocks):
                # all-hop fused path (see A3GNNTrainer._train_fn)
                caps = compute_level_caps(len(mb.seeds), self.cfg.fanout,
                                          slot.graph.num_nodes)
                arrays = batch_device_arrays(mb, level_caps=caps)
                enc0, aux0, table = plane.fused_inputs(mb.input_ids,
                                                       arrays["pads"][0])
                grads, loss, acc = self._grad_allfused(
                    self.params, dev(enc0), dev(aux0), dev(table),
                    [dev(i) for i in arrays["neigh_idxs"]],
                    dev(arrays["labels"]))
            else:
                arrays = batch_device_arrays(mb)
                grads, loss, acc = self._grad(
                    self.params, dev(arrays["features"]),
                    [dev(i) for i in arrays["neigh_idxs"]],
                    dev(arrays["labels"]))
            slot.pending_grads = grads
            return float(loss), float(acc)
        return fn

    def _next_seeds(self, slot: PartitionSlot) -> np.ndarray:
        for _ in range(2):
            if slot._seed_iter is None:
                slot._seed_iter = seed_loader(
                    slot.graph, self.cfg.batch_size,
                    self.seed + slot.index + 131 * slot._epoch)
            try:
                return next(slot._seed_iter)
            except StopIteration:
                slot._seed_iter = None
                slot._epoch += 1
        # partition smaller than one batch: sample train seeds w/ replacement
        ids = np.where(slot.graph.train_mask)[0]
        if len(ids) == 0:
            ids = np.arange(slot.graph.num_nodes)
        rng = np.random.default_rng(self.seed + slot.index
                                    + 131 * slot._epoch)
        slot._epoch += 1
        return rng.choice(ids, size=self.cfg.batch_size,
                          replace=True).astype(np.int64)

    # ------------------------------------------------------------------
    def _consume_synced_step(self):
        """Consume one submitted batch per partition, all-reduce the
        gradients, apply the single shared optimizer update."""
        grads = []
        for slot in self.slots:
            if not slot.pipe.step():
                raise RuntimeError(f"partition {slot.index}: no batch "
                                   f"in flight for the synced step")
            grads.append(slot.pending_grads)
            slot.pending_grads = None
        mean = self._allreduce(grads)
        self.params, self.opt_state = self._apply(self.params, self.opt_state,
                                                  mean)
        self.global_steps += 1
        self._maybe_refresh_halo()

    # ------------------------------------------------------------------
    # dynamic topology: cut-fraction drift tracking + incremental rebalance
    # ------------------------------------------------------------------
    def cut_drift(self) -> float:
        """How much the live cut fraction has degraded past the plan-time
        baseline: ``assignment_cut_fraction`` of the CURRENT adjacency
        (overlay included) minus the fraction at plan build.  0 while the
        graph's ``topology_version`` still matches the plan's (the cheap
        guard — no edge scan unless topology actually moved)."""
        if self.full_graph.topology_version == self.plan.topology_version:
            return 0.0
        cur = assignment_cut_fraction(self.full_graph, self.plan.owner)
        return max(cur - self._plan_cut_fraction, 0.0)

    def rebalance_partitions(self, pipe: Optional[MultiPipeline] = None,
                             max_move_frac: Optional[float] = None
                             ) -> RebalanceResult:
        """Incremental re-balance after topology drift: migrate boundary
        nodes only (``graph/partition.py:incremental_rebalance``), then
        rebuild the per-partition slots through the same in-place
        reconfigure discipline as ``set_halo_budget`` — drain, shutdown,
        new plan, new slots, halo refill.  Params and optimizer state are
        untouched (they are partition-independent); cache and halo
        accounting start FRESH because node ownership moved — the same
        invariant ``_after_restore`` enforces across a partition-count
        migration.  Over a group every process calls it, after the same
        topology edits: it first checks that they agree
        (``fleet_fingerprint``)."""
        if self._group:
            agree(self.mesh, "rebalance_partitions: every process must "
                  "receive the same topology edits between the same "
                  "global steps", self.fleet_fingerprint())
        if max_move_frac is None:
            max_move_frac = getattr(self.cfg, "rebalance_max_move", 0.25)
        if pipe is not None:
            pipe.drain()
        for slot in self.slots:
            slot.pipe.shutdown()
        res = incremental_rebalance(self.full_graph, self.plan,
                                    max_move_frac=float(max_move_frac))
        self.plan = res.plan
        self.slots = self._make_slots()
        self.halo_exchange_bytes = self._fill_halo_features()
        self._halo_dirty = False         # every halo row was just refilled
        self._plan_cut_fraction = res.cut_after
        self.eta = float(np.mean(self.plan.etas(self.full_graph)))
        self.rebalances += 1
        self.last_rebalance = res
        return res

    def _maybe_rebalance(self):
        """Drift trigger, checked between global steps (never mid-window:
        ``MultiPipeline.run`` holds submitted batches in the slot pipes,
        and a rebalance replaces those pipes).  Over a group the processes
        gather their topology version and decision first."""
        thresh = getattr(self.cfg, "rebalance_drift", 0.0)
        if thresh <= 0:
            return
        drifted = self.cut_drift() > thresh
        agree(self.mesh, "the drift trigger",
              (int(self.full_graph.topology_version), drifted))
        if drifted:
            self.rebalance_partitions()

    def global_step(self, fail_worker: Optional[int] = None):
        """One gradient-synchronized step: each partition samples + batches
        one mini-batch from its own subgraph through its own pipeline."""
        self._maybe_rebalance()
        for slot in self.slots:
            slot.pipe.submit([self._next_seeds(slot)],
                             fail_worker=(fail_worker if slot.index == 0
                                          else None))
        self._consume_synced_step()

    def synced_update(self, arrays_list: List[Dict]):
        """One data-parallel update from pre-generated per-partition batch
        arrays (``batch_device_arrays``; gradient-parity harness, bypasses
        sampling): one entry per partition this process holds.  Returns
        the mean loss and accuracy over every partition."""
        dev = self._to_device
        grads, losses, accs = [], [], []
        for arrays in arrays_list:
            g, loss, acc = self._grad(self.params, dev(arrays["features"]),
                                      [dev(i) for i in arrays["neigh_idxs"]],
                                      dev(arrays["labels"]))
            grads.append(g)
            losses.append(float(loss))
            accs.append(float(acc))
        mean = self._allreduce(grads)
        self.params, self.opt_state = self._apply(self.params, self.opt_state,
                                                  mean)
        self.global_steps += 1
        self._maybe_refresh_halo()       # same contract as the synced step
        losses, accs = zip(*[v for vals in all_gather_objects(
            self.mesh, list(zip(losses, accs))) for v in vals])
        return float(np.mean(losses)), float(np.mean(accs))

    # ------------------------------------------------------------------
    # weight hand-off to serving replicas: every optimizer step returns new
    # tensors and never writes into the old ones, so an export is a
    # consistent snapshot while the trainer moves on
    # ------------------------------------------------------------------
    def get_weights(self) -> Dict:
        return {"params": self.params}

    def set_weights(self, weights: Dict):
        self.params = weights["params"]

    # ------------------------------------------------------------------
    def make_pipeline(self) -> MultiPipeline:
        return MultiPipeline(self)

    def steps_per_epoch(self) -> int:
        """Global steps per epoch: the slowest partition sets the pace."""
        return max(max(int(g.train_mask.sum()) // self.cfg.batch_size
                       for g in self.plan.subgraphs), 1)

    def run_epochs(self, epochs: int = 1,
                   max_steps_per_epoch: Optional[int] = None,
                   mode: Optional[str] = None,
                   fail_worker: Optional[int] = None,
                   warmup_steps: int = 0, simulate: bool = False):
        """Mirror of ``A3GNNTrainer.run_epochs`` over the partition fleet.
        ``simulate`` is accepted for signature parity (execution is already
        sequential-per-host)."""
        del simulate
        pipe = self.make_pipeline()
        target_mode = mode or self.cfg.parallel_mode
        if warmup_steps:
            pipe.run(mode="seq", max_steps=warmup_steps)
            pipe.reconfigure(mode=target_mode)
            for c in self.caches:
                if c is not None:
                    c.stats.reset()
        try:
            # same per-epoch stats merge as the single-partition trainer
            agg = A3GNNTrainer._run_pipe_epochs(pipe, target_mode, epochs,
                                                max_steps_per_epoch,
                                                fail_worker)
        finally:
            pipe.shutdown()
        steps_per_epoch = (max_steps_per_epoch
                           if max_steps_per_epoch is not None
                           else self.steps_per_epoch())
        parts = self.plan.parts
        global_steps = max(agg.steps // parts, 1)
        sps = (global_steps * parts) / agg.t_wall if agg.t_wall else 0.0
        st = agg.stage_times()
        step_t = bottleneck_step_time(target_mode, st, self.cfg.workers)
        msps = parts / max(step_t, 1e-9)            # aggregate scale-out rate
        return RunResult(
            throughput_steps_s=sps,
            throughput_epochs_s=sps / max(steps_per_epoch * parts, 1),
            modeled_steps_s=msps,
            modeled_epochs_s=msps / max(steps_per_epoch * parts, 1),
            memory_bytes=self.modeled_memory(agg, mode=target_mode),
            test_acc=self.evaluate(),
            cache_hit_rate=self.cache_hit_rate,
            stats=agg, steps_per_epoch=steps_per_epoch)

    # ------------------------------------------------------------------
    @property
    def graph(self) -> Graph:
        """The first partition's subgraph this process holds (the
        per-device view: partition 0's, or its rank's in a group)."""
        return self.slots[0].graph

    @property
    def cache(self) -> Optional[FeatureCache]:
        return self.slots[0].cache

    @property
    def caches(self) -> List[Optional[FeatureCache]]:
        """The caches of the partitions this process holds."""
        return [s.cache for s in self.slots]

    @property
    def cache_hit_rate(self) -> float:
        counts = [c for c in self._over_parts(
            lambda s: None if s.cache is None
            else (s.cache.stats.hits, s.cache.stats.misses)) if c is not None]
        hits = sum(h for h, _ in counts)
        total = hits + sum(m for _, m in counts)
        return hits / total if total else 0.0

    @property
    def halo_stats(self) -> List[HaloStats]:
        """Every partition's ``HaloStats`` (copies gathered over a
        group)."""
        return self._over_parts(lambda s: s.halo_stats)

    @property
    def fused_grad_calls(self) -> int:
        """All-fused gradient calls summed over every partition."""
        return sum(all_gather_objects(
            self.mesh, self._grad_allfused.counters["calls"]
            if self._grad_allfused else 0))

    @property
    def halo_hit_rate(self) -> float:
        """Fleet-wide fraction of batch input nodes served from the halo."""
        stats = self.halo_stats
        hits = sum(h.halo_hits for h in stats)
        total = sum(h.inputs for h in stats)
        return hits / total if total else 0.0

    def model_bytes(self, stats: PipelineStats) -> float:
        act_factor = max(3.0 * self.cfg.hidden * self.cfg.num_layers
                         / max(self.cfg.feat_dim, 1), 1.0)
        return 3 * param_bytes(self.decls) + stats.peak_batch_bytes * act_factor

    @staticmethod
    def runtime_bytes() -> float:
        return RUNTIME_BYTES

    def modeled_memory(self, stats: PipelineStats,
                       mode: Optional[str] = None,
                       workers: Optional[int] = None) -> float:
        """Fleet footprint: every partition replicates model + runtime and
        owns its cache/batches, so the Eq. 3/5 per-worker term × partitions."""
        cache_bytes = max((b for b in self._over_parts(
            lambda s: None if s.cache is None else s.cache.volume_bytes())
            if b is not None), default=0.0)
        mt = MemoryTerms(cache_bytes=cache_bytes,
                         batch_bytes=max(stats.peak_batch_bytes, 1),
                         model_bytes=self.model_bytes(stats),
                         runtime_bytes=RUNTIME_BYTES)
        mode = mode or self.cfg.parallel_mode
        workers = workers if workers is not None else self.cfg.workers
        per_part = {"mode1": lambda t: memory_mode1(t, workers),
                    "mode2": lambda t: memory_mode2(t, workers),
                    "seq": memory_seq}[mode](mt)
        # budgeted halo feature rows are replicated device-side state
        halo_bytes = self.plan.halo_rows * self.full_graph.feat_dim * 4
        return per_part * self.plan.parts + halo_bytes

    def predicted_accuracy_drop(self) -> float:
        cache_frac = ((self.cache.capacity / self.graph.num_nodes)
                      if self.cache else 0.0)
        return accuracy_drop_model(self.eta, self.cfg.bias_rate,
                                   self.full_graph.density(), cache_frac)

    # ------------------------------------------------------------------
    def set_halo_budget(self, budget: int,
                        pipe: Optional[MultiPipeline] = None):
        """LIVE halo-budget swap: re-budget the existing assignment
        (``PartitionPlan.with_halo_budget`` — owner/node_sets untouched, so
        no re-partition and no restart path), rebuild the per-partition
        slots in place, and refill halo rows through the mesh into each
        slot's feature plane.  Params, optimizer state and cache hit
        accounting carry over; in-flight batches are drained first (nothing
        dropped).  Halo accounting starts FRESH — it describes the current
        halo topology, and a budget change swaps that topology (the same
        invariant ``_after_restore`` enforces on the checkpoint path).
        Over a group every process calls it with the same budget."""
        budget = max(int(budget), 0)
        if budget == self.plan.halo_budget:
            self.cfg = self.cfg.replace(halo_budget=budget)
            return
        if pipe is not None:
            pipe.drain()
        old = self.slots
        for slot in old:
            slot.pipe.shutdown()
        self.plan = self.plan.with_halo_budget(self.full_graph, budget)
        self.cfg = self.cfg.replace(halo_budget=budget)
        self.slots = self._make_slots()
        self.halo_exchange_bytes = self._fill_halo_features()
        self._halo_dirty = False     # the re-budget refilled every halo row
        for new, prev in zip(self.slots, old):
            if new.cache is not None and prev.cache is not None:
                new.cache.stats = prev.cache.stats   # accounting survives

    def apply_live_config(self, knobs: Dict,
                          pipe: Optional[MultiPipeline] = None):
        """Episode-boundary reconfiguration, fanned out to every partition
        (same contract as ``A3GNNTrainer.apply_live_config``; the
        ``partitions`` knob itself needs the restart path instead, while
        ``halo_budget`` swaps live through ``set_halo_budget``)."""
        if "halo_budget" in knobs:
            self.set_halo_budget(int(knobs["halo_budget"]), pipe)
        updates = {k: knobs[k] for k in ("bias_rate", "cache_volume_mb",
                                         "parallel_mode", "workers",
                                         "batch_size", "sampling_device")
                   if k in knobs}
        if "workers" in updates:
            updates["workers"] = int(updates["workers"])
        if "batch_size" in updates:
            updates["batch_size"] = int(updates["batch_size"])
        self.cfg = self.cfg.replace(**updates)
        for slot in self.slots:
            if "cache_volume_mb" in updates:
                vol = float(updates["cache_volume_mb"])
                if vol <= 0:
                    slot.cache = None
                elif slot.cache is None:
                    slot.cache = FeatureCache(slot.graph, vol,
                                              self.cfg.cache_policy)
                else:
                    slot.cache.resize(vol)
            if "cache_volume_mb" in updates or "bias_rate" in updates:
                slot.weight_fn = (bias_weight_fn(slot.cache,
                                                 self.cfg.bias_rate)
                                  if (slot.cache is not None
                                      and self.cfg.bias_rate > 1.0) else None)
        if pipe is not None:
            pipe.reconfigure(mode=updates.get("parallel_mode"),
                             workers=updates.get("workers"),
                             batch_size=updates.get("batch_size"),
                             sampling_device=updates.get("sampling_device"))

    def fit_autotuned(self, autotune=None, seed: Optional[int] = None):
        """Online auto-tuning over the partition fleet (paper §III-C); with
        ``autotune.max_partitions > 1`` the controller also tunes the
        partition count through the checkpoint → rebuild → restore path.
        Over a group every process runs it (one controller a process, in
        lockstep)."""
        from repro_torch.core.autotune.controller import fit_autotuned
        return fit_autotuned(self, autotune, seed)

    # ------------------------------------------------------------------
    def evaluate(self, max_batches: int = 8) -> float:
        """Test accuracy, averaged over per-partition held-out batches
        (every partition's, gathered over a group)."""
        dev = self._to_device
        accs = []
        budget = max(max_batches // self.plan.parts, 1)
        for slot in self.slots:
            if not slot.graph.test_mask.any():
                continue
            sampler = NeighborSampler(slot.graph, self.cfg.fanout,
                                      weight_fn=None,
                                      seed=self.seed + 12345 + slot.index)
            for i, seeds in enumerate(seed_loader(
                    slot.graph, self.cfg.batch_size, self.seed,
                    mask=slot.graph.test_mask)):
                if i >= budget:
                    break
                mb = generate_batch(sampler.sample(seeds), None, slot.graph)
                arrays = batch_device_arrays(mb)
                accs.append(float(self._eval(
                    self.params, dev(arrays["features"]),
                    [dev(a) for a in arrays["neigh_idxs"]],
                    dev(arrays["labels"]))))
        accs = [a for part in all_gather_objects(self.mesh, accs)
                for a in part]
        return float(np.mean(accs)) if accs else 0.0

    # ------------------------------------------------------------------
    # checkpoint / restore — TrainerCheckpointMixin provides state_dict /
    # load_state_dict / save / restore (+ the partition-count guard)
    # ------------------------------------------------------------------
    def checkpoint_extra(self) -> Dict:
        """Manifest payload: topology + per-partition cache AND halo
        accounting, so a restore resumes with hit/miss history (and the
        restart path can verify what it is migrating)."""
        return {**super().checkpoint_extra(),
                "partition_method": self.plan.method,
                "halo_budget": int(self.plan.halo_budget),
                "topology_version": int(self.plan.topology_version),
                "rebalances": int(self.rebalances),
                "cache_stats": self._over_parts(
                    lambda s: dataclasses.asdict(s.cache.stats)
                    if s.cache is not None else None),
                "halo_stats": self._over_parts(
                    lambda s: dataclasses.asdict(s.halo_stats))}

    def _after_restore(self, extra: Dict, step: int):
        self.global_steps = int(extra.get("global_steps", step))
        self.rebalances = int(extra.get("rebalances", 0))
        # cache/halo hit-accounting carries over only on a same-topology
        # restore (after a migration the per-partition objects are new)
        if int(extra.get("partitions", self.plan.parts)) == self.plan.parts:
            cache_stats = extra.get("cache_stats") or []
            halo_stats = extra.get("halo_stats") or []
            for slot in self.slots:
                st = (cache_stats[slot.index]
                      if slot.index < len(cache_stats) else None)
                if slot.cache is not None and st:
                    for k, v in st.items():
                        setattr(slot.cache.stats, k, int(v))
            # ...and halo accounting additionally requires the same budget
            # (restoring budget>0 hits into a budget=0 topology would
            # report a halo hit rate on a fleet that has no halo)
            if int(extra.get("halo_budget",
                             self.plan.halo_budget)) == self.plan.halo_budget:
                for slot in self.slots:
                    st = (halo_stats[slot.index]
                          if slot.index < len(halo_stats) else None)
                    if st:
                        for k, v in st.items():
                            setattr(slot.halo_stats, k, int(v))

    def fit_supervised(self, steps: int, ckpt_dir, ckpt_every: int = 0,
                       max_restarts: int = 3,
                       fail_at_step: Optional[int] = None
                       ) -> SupervisorReport:
        """Train ``steps`` global steps under the fault-tolerance supervisor:
        periodic checkpoints, restore-and-resume on failure
        (``fail_at_step`` injects one for tests).  Over a group every
        process runs it: rank 0 writes into ``ckpt_dir``, an injected
        failure fires on every process at the same step, and every
        process restores the same committed step."""
        ckpt = (GroupCheckpointManager(ckpt_dir, self.mesh, keep=2)
                if self._group else
                CheckpointManager(ckpt_dir, keep=2, async_save=False))
        sup = TrainSupervisor(ckpt, ckpt_every or max(steps // 2, 1),
                              max_restarts, extra_fn=self.checkpoint_extra)
        injected = {"armed": fail_at_step is not None}

        def step_fn(state, step):
            self.load_state_dict(state)      # supervisor may have restored
            if injected["armed"] and step == fail_at_step:
                injected["armed"] = False
                raise RuntimeError(f"injected node failure at step {step}")
            self.global_step()
            return self.state_dict()

        state, rep = sup.run(self.state_dict(), step_fn, steps)
        self.load_state_dict(state)
        return rep


class IdleRank(FeatureStreamConsumer):
    """A process of a ``torch.distributed`` group past the fleet's
    partition count: it holds no partition and runs no step.  It keeps
    what the auto-tuner's controller needs between restarts — the full
    graph, the configuration of record, the seed, the assigner and the
    device — and any attached ``FeatureStore``, whose stream goes on
    writing this process's copy of the full graph, so the process rejoins
    a later restart's fleet from the current features and that restart's
    checkpoint.  Over more than one partition it joins the fleet's process
    group as it is made (``make_partition_mesh``, a collective of every
    process)."""

    holds_partition = False

    def __init__(self, graph: Graph, cfg: GNNConfig, seed: int = 0,
                 method: str = "locality", device="cuda"):
        self.full_graph = graph
        self.cfg = cfg
        self.seed = seed
        self.method = method
        self.device = torch.device(device)
        self.mesh = (make_partition_mesh(cfg.partitions, self.device)
                     if cfg.partitions > 1 else None)
        world = world_mesh()
        if world is None or world.rank < cfg.partitions:
            raise ValueError(f"an idle rank is a process past the "
                             f"{cfg.partitions} partitions of a group, not "
                             f"rank {None if world is None else world.rank}")

    def _on_feature_update(self, ids: np.ndarray, rows: np.ndarray):
        del ids, rows            # the store wrote this process's full graph

    def apply_live_config(self, knobs: Dict, pipe=None):
        """Nothing to apply: the fleet applies the knobs, and rank 0 holds
        the configuration of record."""
        del knobs, pipe

    def make_pipeline(self):
        return None

    def fit_autotuned(self, autotune=None, seed: Optional[int] = None):
        """This process's controller of the group's auto-tuner: it proposes
        with the others, runs no step and rejoins at a restart that gives
        it a partition."""
        from repro_torch.core.autotune.controller import fit_autotuned
        return fit_autotuned(self, autotune, seed)


def make_rank_trainer(graph: Graph, cfg: GNNConfig, seed: int = 0,
                      partition_method: str = "locality", device="cuda"):
    """This process's share of a ``cfg.partitions`` fleet: ``make_trainer``
    outside a group and on ranks below the partition count, an
    ``IdleRank`` past it.  Inside a group every process calls it at the
    same point: the fleet's process group is made then."""
    from repro_torch.core.a3gnn import make_trainer
    world = world_mesh()
    if world is not None and world.rank >= cfg.partitions:
        return IdleRank(graph, cfg, seed=seed, method=partition_method,
                        device=device)
    return make_trainer(graph, cfg, seed=seed,
                        partition_method=partition_method, device=device)
