"""Model API of the port's LM families: ``build(cfg)`` → :class:`Model`.

A port of ``src/repro/models/api.py`` for ``family == "dense"``; the
members are plain functions, parameters first:

  * ``decls``                          parameter declarations
  * ``prefill(params, batch)``         → (logits, caches)  the block prefill
  * ``decode(params, caches, batch)``  → (logits, caches)  one decode step
  * ``cache_decls(batch, len)``        decode-cache declarations

``compute_params`` makes the one compute-dtype copy of the f32 master
weights that a serving engine keeps.  The loss (training) and the dry-run's
``input_specs`` are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

NOT_PORTED = "not ported yet: the port serves the dense LMs (ROADMAP.md)"


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    decls: Any
    prefill: Callable
    decode: Callable
    cache_decls_fn: Callable            # (batch, cache_len) -> decls

    def cache_decls(self, batch: int, cache_len: int):
        return self.cache_decls_fn(batch, cache_len)


def build(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is {NOT_PORTED}")
    if cfg.is_moe or not cfg.use_rope or cfg.mrope_sections \
            or cfg.mlp_type != "swiglu":
        raise NotImplementedError(f"{cfg.name}: MoE, NoPE, M-RoPE and "
                                  f"non-SwiGLU layers are {NOT_PORTED}")
    return Model(cfg=cfg, decls=T.decls_lm(cfg),
                 prefill=lambda p, b: T.prefill(p, b, cfg),
                 decode=lambda p, c, b: T.decode_step(p, c, b, cfg),
                 cache_decls_fn=lambda batch, n: T.cache_decls(cfg, batch, n))


def compute_params(params, cfg: ModelConfig):
    """The weights in ``cfg.compute_dtype``: the values JAX's
    ``.astype(x.dtype)`` gives at each use, made once.  Norm scales, which
    the model reads in f32, stay as they are; at f32 nothing is copied."""
    cdt = T._cdt(cfg)

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        return tree if key == "scale" else tree.to(cdt)
    return cast(params)
