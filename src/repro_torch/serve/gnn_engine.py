"""Online GNN inference serving over the training-side FeaturePlane.

Answers per-node prediction requests ("what class is node v, given the
LIVE graph and features?") with the same machinery that makes training
affordable on CPU-GPU platforms (paper §III):

  * **incremental sampling** — each engine step samples the admitted
    seeds' neighborhoods on demand with the locality-aware
    ``core/sampling.py`` ``NeighborSampler`` (bias γ toward cached ids,
    exactly like the training sampler, so serving latency benefits from
    the same cache the trainer warmed);
  * **the FeaturePlane seam** — features are fetched through the SAME
    ``core/feature_plane.py`` plane a trainer built (host numpy cache or
    the device-resident CUDA ``cache_gather``), so the γ/Θ cache, its
    hit/miss accounting and the device-mirror versioning all carry over
    from training to serving;
  * **continuous batching** — a fixed pool of ``batch`` slots, FIFO
    admission through the serve/common.py ``EngineBase`` seam, one
    forward-only step per iteration over the active slots, run eagerly
    under ``torch.inference_mode()`` on ``device`` (every node level
    padded to a fixed per-engine cap, and no phantom filler traffic
    through the shared plane), completed requests retire immediately and
    waiting queries join.

As a partition replica (serve/fabric.py): constructed with a
``node_map`` (global → local id, −1 for nodes owned elsewhere) the
engine serves GLOBAL node ids against its partition subgraph — queries
keep their fleet-wide identity, seeds are translated only at sampling
time, and the fabric's ``retire_hook`` observes every retirement.
Weight hand-off follows the get/set-weights discipline: a trainer's
exported tree swaps in BETWEEN steps, so in-flight requests (each
computed wholly inside one step) never see a half-updated model.

Streaming updates: subscribe the plane to a ``graph/storage.py``
``FeatureStore`` (``plane.subscribe_to(store)``) and a mid-serving
``update_rows`` is reflected in the very next prediction on BOTH
backends — the cache-resident copy updates in place and the device
mirror re-syncs off ``FeatureCache.version``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.feature_plane import FeaturePlane, make_feature_plane
from repro_torch.core.sampling import NeighborSampler
from repro_torch.graph.batch import (generate_batch, inference_arrays,
                                     compute_level_caps)
from repro_torch.graph.storage import Graph
from repro_torch.models.gnn import gnn_forward
from repro_torch.serve.common import EngineBase, admit_pending


@dataclass
class GNNRequest:
    """One node-prediction query (the GNN twin of engine.py's Request).

    ``status`` makes retirement explicit: ``done`` (``pred``/``logits``
    are real), ``shed`` (SLO admission dropped it — ``pred`` stays the
    −1 sentinel and must not be read as a class) or ``timeout`` (the
    fabric stopped waiting on every dispatched attempt — same sentinel
    rule).  ``partition`` is stamped by the fabric router; −1 means not
    fabric-routed.  ``replica``/``retries`` are the fabric's dispatch
    record: the last replica the request was sent to, and how many
    attempts gave up (timer expiry or a replica going down) before this
    one.  ``t_first`` is the slot-admission stamp (TTFT = queue wait
    for a single-shot query)."""
    rid: int
    node: int                          # node id to classify (GLOBAL under
    #                                    a fabric; engine-graph-local else)
    pred: int = -1                     # argmax class (valid iff status=="done")
    logits: Optional[np.ndarray] = None  # (num_classes,) float32
    status: str = "pending"            # pending | done | shed | timeout
    partition: int = -1                # owning partition (fabric-routed)
    replica: int = -1                  # last dispatch target (fabric-stamped)
    retries: int = 0                   # failed attempts before this one
    # graph topology version at admission (fabric-stamped; −1 = unrouted):
    # a query answers against the topology it was admitted under — edges
    # streamed after the stamp only affect later requests
    topology_version: int = -1
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class GNNInferenceEngine(EngineBase):
    """Continuous-batching node-prediction engine over a FeaturePlane.

    ``plane`` is intended to be the plane a trainer's pipeline built
    (``from_trainer`` wires that up) — sharing it means serving hits the
    warmed cache and its accounting proves the reuse.  A standalone
    engine (no trainer) gets a fresh plane over the bare host store.
    """

    def __init__(self, graph: Graph, cfg, params,
                 plane: Optional[FeaturePlane] = None, batch: int = 8,
                 weight_fn=None, seed: int = 0,
                 keep_completed: int = 4096,
                 node_map: Optional[np.ndarray] = None,
                 retire_hook: Optional[Callable] = None, device="cuda"):
        self.graph = graph
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        # node_map: (N_global,) local id within `graph`, −1 if not owned
        # here — a fabric replica serves global ids over its subgraph
        self.node_map = (np.asarray(node_map, dtype=np.int32)
                         if node_map is not None else None)
        self._id_space = (len(self.node_map) if self.node_map is not None
                          else graph.num_nodes)
        owned = (int((self.node_map >= 0).sum())
                 if self.node_map is not None else graph.num_nodes)
        # seeds must be UNIQUE (the sampler's dedup/reindex invariant),
        # so in-flight queries are distinct nodes — a pool larger than
        # the servable node set could never fill
        if batch > owned:
            raise ValueError(f"batch {batch} exceeds the {owned}-node "
                             f"servable set (in-flight seeds must be "
                             f"distinct nodes)")
        self._init_serving(batch, keep_completed, retire_hook)
        self.running: Dict[int, GNNRequest] = {}   # slot -> request
        # fixed per-level pad caps → one shape for this engine's forward,
        # ever (graph/batch.py:compute_level_caps)
        self._level_caps = compute_level_caps(batch, cfg.fanout,
                                              graph.num_nodes)
        self.plane = (plane if plane is not None else
                      make_feature_plane(graph, None, cfg.sampling_device,
                                         self.device))
        self.sampler = NeighborSampler(graph, cfg.fanout,
                                       weight_fn=weight_fn, seed=seed)
        self.steps = 0

    def _fwd(self, params, feats: np.ndarray, idxs) -> np.ndarray:
        """Forward-only step on ``device``; logits come back as numpy."""
        with torch.inference_mode():
            logits = gnn_forward(
                params, torch.from_numpy(feats).to(self.device),
                [torch.from_numpy(i).to(self.device) for i in idxs],
                self.cfg)
            return logits.float().cpu().numpy()

    @classmethod
    def from_trainer(cls, trainer, batch: int = 8,
                     plane: Optional[FeaturePlane] = None,
                     seed: int = 0) -> "GNNInferenceEngine":
        """Serve with the trainer's feature machinery: pass the live
        pipeline's plane (``trainer.make_pipeline().plane``) to share the
        exact plane INSTANCE, or let this build one around the trainer's
        cache — either way hit/miss accounting is the trainer's own
        ``FeatureCache.stats`` and the γ bias is the trainer's
        ``weight_fn``."""
        if plane is None:
            plane = make_feature_plane(trainer.graph, trainer.cache,
                                       trainer.cfg.sampling_device,
                                       trainer.device)
        return cls(trainer.graph, trainer.cfg, trainer.params, plane=plane,
                   batch=batch, weight_fn=trainer.weight_fn, seed=seed,
                   device=trainer.device)

    # ------------------------------------------------------------------
    # weight hand-off (trainer → replica, SNIPPETS §2 discipline): the
    # exported tree swaps in whole, between steps — single-shot requests
    # are computed inside one step, so none ever sees a partial refresh
    # ------------------------------------------------------------------
    def get_weights(self) -> Dict:
        return {"params": self.params}

    def set_weights(self, weights: Dict):
        self.params = weights["params"]

    # ------------------------------------------------------------------
    def _validate(self, req: GNNRequest):
        if not (0 <= req.node < self._id_space):
            raise ValueError(f"node {req.node} outside graph "
                             f"[0, {self._id_space})")
        if self.node_map is not None and self.node_map[req.node] < 0:
            raise ValueError(f"node {req.node} is not owned by this "
                             f"partition replica (route via the fabric)")

    def _try_allocate(self, req: GNNRequest) -> Optional[int]:
        free = self.free_slots()
        if not free:
            return None
        if any(r.node == req.node for r in self.running.values()):
            # a same-node query is already in flight: seeds must stay
            # unique, so the FIFO head waits one engine iteration (the
            # in-flight twin retires at the end of this step)
            return None
        return free[0]

    @staticmethod
    def _on_admit(req: GNNRequest, slot: int):
        req.t_first = time.perf_counter()      # TTFT = queue wait

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: admit, sample, gather (through the
        plane), forward, retire.  Returns completed-request count."""
        admit_pending(self.pending, self.running, self._try_allocate,
                      self._on_admit)
        if not self.running:
            return 0
        # one mini-batch over the ACTIVE seeds only — padding free slots
        # with real filler nodes would push phantom traffic through the
        # shared plane (polluting the trainer's CacheStats and, under
        # FIFO, evicting warmed rows).  inference_arrays pads every node
        # level to this engine's fixed caps (padded rows reference only
        # masked −1 neighbors), so the forward has ONE shape no matter how
        # many seeds are admitted or what they sample.
        active_slots = sorted(self.running)
        seeds = np.array([self.running[s].node for s in active_slots],
                         dtype=np.int64)
        if self.node_map is not None:
            seeds = self.node_map[seeds].astype(np.int64)
        mb = self.sampler.sample(seeds)
        mb = generate_batch(mb, self.plane, self.graph)
        arrays = inference_arrays(mb, level_caps=self._level_caps)
        logits = self._fwd(self.params, arrays["features"],
                           arrays["neigh_idxs"])
        now = time.perf_counter()
        retired = 0
        for i, slot in enumerate(active_slots):
            req = self.running.pop(slot)
            req.logits = logits[i].copy()
            req.pred = int(np.argmax(req.logits))
            req.t_done = now
            self._retire(req)
            retired += 1
        self.steps += 1
        return retired

    # ------------------------------------------------------------------
    def _begin_window(self) -> Dict:
        return {"steps": self.steps}

    def _window_metrics(self, mark: Dict, emitted: int, done: int,
                        dt: float) -> Dict[str, float]:
        out = {"queries_per_s": done / dt if dt else 0.0,
               "engine_steps": self.steps - mark["steps"]}
        if self.plane.stats is not None:
            out["cache_hit_rate"] = self.plane.stats.hit_rate
        return out
