"""GNN training configs — the paper's own workload (A³GNN).

One config per dataset family used in the paper's experiments (Tab. II /
Fig. 6), backed by synthetic power-law graphs with matched statistics
(offline container — see graph/synthetic.py and DESIGN.md §6.5).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple

from repro_torch.configs.base import register


@dataclass(frozen=True)
class AutotuneConfig:
    """Online auto-tuning (paper §III-C) — episode schedule + objective.

    The controller (core/autotune/controller.py) runs ``episodes`` episodes
    of ``steps_per_episode`` real training steps each; between episodes it
    drains the pipeline and applies a new (γ, cache volume, parallel mode,
    workers) configuration proposed by the PPO policy against the surrogate.
    The reward is w·(throughput, -memory, accuracy) with a hard
    ``memory_limit_bytes`` constraint (Algo. 3's -inf reward)."""
    episodes: int = 4
    steps_per_episode: int = 10
    warmup_steps: int = 2            # absorbs jit compiles before episode 0
    eval_batches: int = 2            # accuracy measurement per episode
    # surrogate pre-warm (analytic perf/accuracy models → training points)
    presample: int = 96
    surrogate_trees: int = 24
    # objective weights + constraint
    w_throughput: float = 1.0
    w_memory: float = 1e-9
    w_accuracy: float = 0.5
    memory_limit_bytes: float = float("inf")
    # PPO exploration burst per episode
    ppo_updates: int = 3
    ppo_horizon: int = 8
    # episode design-space bounds (subset of Table I that is live-swappable)
    max_workers: int = 4
    max_cache_mb: float = 64.0
    max_bias_rate: float = 16.0
    # > 0 adds the `batch_size` knob (applies live via Pipeline.reconfigure)
    max_batch_size: int = 0
    # adds the `sampling_device` knob: live feature-plane swap (cpu ↔
    # device cache_gather) without dropping a batch
    tune_sampling_device: bool = False
    # MEASURE-phase throughput: "modeled" (Eqs. 2/4 from measured stage
    # times — the only honest number on a 1-core host, where threads cannot
    # physically overlap), "wallclock" (PipelineStats.throughput_steps_per_s),
    # or "auto" — wall-clock when the process can use > 1 CPU (scheduler
    # affinity mask, so cgroup-pinned containers count as 1-core)
    throughput_source: str = "auto"
    # > 1 adds the `partitions` knob: applied through the restart-capable
    # path (checkpoint → rebuild trainer → restore), not a live swap
    max_partitions: int = 1
    # > 0 adds the `halo_budget` knob (bounded halo-feature exchange);
    # swaps LIVE — the plan is re-budgeted and slots rebuilt in place,
    # params/optimizer state never leave memory
    max_halo_budget: int = 0
    restart_dir: str = ""            # "" → a fresh temp dir per controller
    seed: int = 0

    def replace(self, **kw) -> "AutotuneConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class GNNConfig:
    name: str
    family: str = "gnn"
    model: str = "graphsage"            # graphsage | gcn | gat | gin
    num_layers: int = 3
    hidden: int = 256
    feat_dim: int = 602                 # reddit-like default
    num_classes: int = 41
    fanout: Tuple[int, ...] = (15, 10, 5)
    batch_size: int = 512
    # dataset (synthetic power-law generator parameters)
    num_nodes: int = 100_000
    num_edges: int = 2_000_000
    power_exp: float = 2.1              # degree power-law exponent
    # --- A3GNN knobs (Table I design space) ---
    bias_rate: float = 2.0              # γ ≥ 1; 1 → plain random sampling
    cache_volume_mb: float = 40.0       # Θ
    cache_policy: str = "static"        # static (hotness) | fifo
    sampling_device: str = "cpu"        # cpu | device | auto (follows the device)
    # all-hop fused gather+aggregate (kernels/fused_gather_agg +
    # kernels/segment_agg.neighbor_agg): batch generation defers ALL
    # feature work to the train step, which resolves the input hop from
    # encoded cache slots + a miss sideband and runs every hop's
    # aggregation in place over the previous layer's output buffer —
    # level-capped buffers give ONE jit signature per (model,
    # level_caps).  Supported by all model families (graphsage/gcn/gat/
    # gin); bit-exact with the unfused path on cpu and device planes.
    fused_gather_agg: bool = False
    workers: int = 2
    parallel_mode: str = "seq"          # seq | mode1 | mode2
    partitions: int = 1
    # bounded halo exchange: top-k boundary features each partition keeps
    # (0 → drop cut edges entirely, the paper's no-remote-access setting)
    halo_budget: int = 0
    # streaming graphs: re-run the bounded halo exchange every N global
    # steps WHEN stale (a FeatureStore update touched a halo-resident row);
    # 0 → no periodic refresh (explicit refresh_halo_features() only)
    halo_refresh_interval: int = 0
    # dynamic topology: cut-fraction drift past the plan-time baseline that
    # triggers an incremental re-balance between global steps (boundary-
    # node migration, never a full repartition); ≤ 0 disables the trigger
    # (explicit rebalance_partitions() only)
    rebalance_drift: float = 0.0
    # cap on the fraction of nodes one incremental re-balance may migrate
    rebalance_max_move: float = 0.25
    # --- serving (serve/fabric.py) ---
    # target p99 end-to-end latency for SLO-aware admission; ≤ 0 disables
    # shedding (unconditional admission — queue wait unbounded past
    # saturation, the pre-SLO behavior)
    slo_p99_ms: float = 0.0
    # engines per partition behind the fabric's shared admission scheduler
    serve_replicas: int = 1
    # per-request fabric timeout (serve/transport.py seam): how long the
    # fabric waits on a dispatched replica before retrying the request on
    # another one (once) and then retiring it status=="timeout"; ≤ 0
    # disables — the fabric waits forever, the pre-seam behavior (safe
    # in-process, where a response cannot be lost)
    serve_timeout_ms: float = 0.0
    # training
    lr: float = 3e-3
    dropout: float = 0.0
    compute_dtype: str = "float32"
    # online auto-tuning (core/autotune/controller.py)
    autotune: AutotuneConfig = field(default_factory=AutotuneConfig)

    def replace(self, **kw) -> "GNNConfig":
        return replace(self, **kw)


def _dataset(name, nodes, edges, feat, classes, exp=2.1):
    return dict(num_nodes=nodes, num_edges=edges, feat_dim=feat,
                num_classes=classes, power_exp=exp)


# Scaled-down synthetic twins of the paper's datasets (node/edge counts
# scaled ~25× down to fit the CPU container; density ratios preserved).
DATASETS = {
    "reddit": _dataset("reddit", 93_000, 4_600_000, 602, 41, 1.9),
    "products": _dataset("products", 98_000, 2_470_000, 100, 47, 2.2),
    "arxiv": _dataset("arxiv", 68_000, 466_000, 128, 40, 2.4),
    "amazon": _dataset("amazon", 63_000, 10_570_000, 200, 107, 1.8),
    "yelp": _dataset("yelp", 29_000, 800_000, 300, 100, 2.0),
}

# smoke-scale (unit tests / CI)
DATASETS_SMOKE = {
    k: dict(v, num_nodes=2_000, num_edges=20_000) for k, v in DATASETS.items()
}


def gnn_config(dataset: str = "products", smoke: bool = False, **kw) -> GNNConfig:
    ds = (DATASETS_SMOKE if smoke else DATASETS)[dataset]
    base = GNNConfig(name=f"graphsage-{dataset}" + ("-smoke" if smoke else ""),
                     **ds)
    if smoke:
        base = base.replace(hidden=32, batch_size=64, fanout=(5, 5),
                            num_layers=2, cache_volume_mb=1.0)
    return base.replace(**kw) if kw else base


@register("graphsage-products")
def _products(smoke: bool = False):
    return gnn_config("products", smoke)


@register("graphsage-reddit")
def _reddit(smoke: bool = False):
    return gnn_config("reddit", smoke)
