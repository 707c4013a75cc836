"""Architecture registry: ``--arch <id>`` → config factory, and the LM
families' ``ModelConfig``.

``ModelConfig`` and ``ShapeConfig`` are copies of the JAX package's
(``src/repro/configs/base.py``), fields and ``param_count`` unchanged.  The
port registers the GNN configs (configs/gnn.py) and the LMs of every
family: dense, MoE, SSM, hybrid, encoder-decoder and VLM.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """A single composable description for all supported model families.

    family:
      dense   — decoder-only transformer (GQA, RoPE, optional qk-norm)
      moe     — decoder-only with routed-expert MLPs (+ shared experts)
      ssm     — attention-free Mamba2 (SSD) stack
      hybrid  — Mamba2 backbone + a weight-shared attention block (Zamba2)
      encdec  — encoder-decoder transformer (Whisper-style, frontend stubbed)
      vlm     — decoder-only with M-RoPE, patch embeddings stubbed
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                  # 0 -> d_model // num_heads
    mlp_type: str = "swiglu"           # swiglu | relu2 | gelu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    num_experts_padded: int = 0        # padded so EP axis divides (0 -> num_experts)
    moe_top_k: int = 0
    num_shared_experts: int = 0
    shared_expert_ff: int = 0          # fused shared-expert hidden dim
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0                 # N, state dim per head
    ssm_head_dim: int = 64             # P
    ssm_expand: int = 2                # d_inner = expand * d_model
    ssm_conv_width: int = 4
    ssm_chunk: int = 256               # SSD chunk length

    # --- hybrid (Zamba2) ---
    shared_attn_every: int = 6         # invoke the shared block every k ssm layers

    # --- encoder-decoder ---
    encoder_layers: int = 0
    encoder_seq: int = 0               # fixed frontend length (e.g. 1500 audio frames)

    # --- frontend stubs ---
    frontend: str = "none"             # none | audio | vision
    mrope_sections: Tuple[int, ...] = ()  # M-RoPE half-dim split (t, h, w)
    max_seq: int = 32768               # learned-pos-emb table size (no-rope archs)

    # --- numerics / perf knobs (threaded to the step functions) ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "none"                # none | dots | full
    scan_layers: bool = True
    attn_chunk: int = 0                # 0 -> plain attention; >0 -> chunked (flash-style)
    loss_chunk: int = 0                # 0 -> whole-seq loss; >0 -> chunked xent
    use_pallas: bool = False           # TPU kernel path (dry-run uses XLA-native)
    optimizer: str = "adamw"           # see train/optimizer.py
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    # sharding policy knobs (see distributed/sharding.py)
    kv_shard: str = "auto"             # auto | heads | sequence | replicated
    shard_experts_fsdp: bool = True    # second-axis FSDP sharding of expert weights
    grad_accum: int = 1                # microbatches per step (memory knob)
    fsdp_params: bool = True           # ZeRO-3 param sharding over data;
                                       # False = TP-only (serving profile)
    pad_head_groups: bool = False      # zero-pad q-heads per kv group so the
                                       # flat head count divides the TP axis

    notes: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.num_experts and not self.num_experts_padded:
            object.__setattr__(self, "num_experts_padded", self.num_experts)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for MODEL_FLOPS and memory budgeting) -------
    def param_count(self) -> int:
        D, H, Hkv, Dh, F, V = (self.d_model, self.num_heads, self.num_kv_heads,
                               self.head_dim, self.d_ff, self.vocab_size)
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
        if self.mlp_type == "swiglu":
            mlp = 3 * D * F
        else:
            mlp = 2 * D * F
        if self.family == "ssm":
            per = self._ssm_params()
            return emb + self.num_layers * per
        if self.family == "hybrid":
            per = self._ssm_params()
            shared = attn + 3 * D * self.d_ff + 2 * D * D  # shared block + in/out proj
            return emb + self.num_layers * per + shared
        if self.family == "encdec":
            enc = self.encoder_layers * (attn + mlp)
            dec = self.num_layers * (attn + attn + mlp)  # self + cross
            return emb + enc + dec
        if self.is_moe:
            expert = 3 * D * F * self.num_experts
            shared = 3 * D * self.shared_expert_ff if self.shared_expert_ff else 0
            router = D * self.num_experts
            per = attn + expert + shared + router
            return emb + self.num_layers * per
        return emb + self.num_layers * (attn + mlp)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top-k + shared only)."""
        if not self.is_moe:
            if self.family == "hybrid":
                return self.param_count()  # shared block reused; all params active
            return self.param_count()
        D, F = self.d_model, self.d_ff
        H, Hkv, Dh = self.num_heads, self.num_kv_heads, self.head_dim
        attn = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
        expert_active = 3 * D * F * self.moe_top_k
        shared = 3 * D * self.shared_expert_ff if self.shared_expert_ff else 0
        router = D * self.num_experts
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        return emb + self.num_layers * (attn + expert_active + shared + router)

    def _ssm_params(self) -> int:
        D = self.d_model
        d_inner = self.ssm_expand * D
        nheads = d_inner // self.ssm_head_dim
        N = self.ssm_state
        conv_dim = d_inner + 2 * N * nheads if False else d_inner + 2 * N
        # in_proj: [D, 2*d_inner + 2*groups*N + nheads]; out_proj [d_inner, D]
        in_proj = D * (2 * d_inner + 2 * N + nheads)
        conv = self.ssm_conv_width * (d_inner + 2 * N)
        out_proj = d_inner * D
        extra = nheads * 3  # A_log, D, dt_bias
        return in_proj + conv + out_proj + extra


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ModelConfig) -> List[ShapeConfig]:
    """long_500k needs sub-quadratic attention -> SSM/hybrid only."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.family in ("ssm", "hybrid"):
        shapes.append(LONG_500K)
    return shapes

_REGISTRY: Dict[str, Any] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, smoke: bool = False):
    import repro_torch.configs as _pkg  # noqa: F401  (triggers arch module imports)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](smoke=smoke)


def list_archs() -> List[str]:
    import repro_torch.configs as _pkg  # noqa: F401
    return sorted(_REGISTRY)
