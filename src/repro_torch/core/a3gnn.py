"""A³GNN trainer, the parts the serving path needs.

``A3GNNTrainer`` wires together the feature cache, the locality-aware
(bias-rate γ) weighted-reservoir sampler, the pipeline and the unfused GNN
train step, with parameters and optimizer state on ``device``.

Not ported yet (ROADMAP.md, slice 2): the fused train step
(``fused_gather_agg``), ``run_epochs``/``evaluate``, the modeled memory,
checkpointing and the autotune hooks.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.gnn import GNNConfig
from repro_torch.core.cache import FeatureCache
from repro_torch.core.locality import bias_weight_fn
from repro_torch.core.pipeline import Pipeline
from repro_torch.graph.batch import batch_device_arrays
from repro_torch.graph.partition import overlap_ratio, partition
from repro_torch.graph.storage import Graph
from repro_torch.models.gnn import decls_gnn, make_train_step
from repro_torch.models.params import init_params
from repro_torch.train.optimizer import make_adamw


class A3GNNTrainer:
    def __init__(self, graph: Graph, cfg: GNNConfig, seed: int = 0,
                 device="cuda"):
        if cfg.fused_gather_agg:
            raise NotImplementedError("fused_gather_agg is not ported yet — "
                                      "see ROADMAP.md")
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

    def _to_device(self, a):
        return torch.from_numpy(a).to(self.device)

    def _train_fn(self, mb, plane=None):
        arrays = batch_device_arrays(mb)
        self.params, self.opt_state, loss, acc = self._step(
            self.params, self.opt_state, self._to_device(arrays["features"]),
            [self._to_device(i) for i in arrays["neigh_idxs"]],
            self._to_device(arrays["labels"]))
        return float(loss), float(acc)

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
