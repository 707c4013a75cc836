"""Model API of the port's LM families: ``build(cfg)`` → :class:`Model`.

A port of ``src/repro/models/api.py`` for every LM family: ``dense``,
``moe``, ``vlm`` (the dense model with M-RoPE and a vision prefix),
``ssm``, ``hybrid`` and ``encdec``; the members are plain functions,
parameters first:

  * ``decls``                          parameter declarations
  * ``loss_fn(params, batch)``         → (loss, metrics)   training
  * ``prefill(params, batch)``         → (logits, caches)  the block prefill
  * ``decode(params, caches, batch)``  → (logits, caches)  one decode step
  * ``cache_decls(batch, len)``        decode-cache declarations
  * ``input_specs(shape)``             ``meta`` stand-ins for every input
                                       and their logical partition specs:
                                       the dry-run's entry (launch/dryrun.py)

The pure-SSM LM (a Mamba2 stack) lives here, as in JAX.
``compute_params`` makes the one compute-dtype copy of the f32 master
weights that a serving engine keeps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import P, constrain
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.params import ParamDecl, abstract_params, stack_decls

VISION_PREFIX = 1024  # stubbed patch-embedding prefix length (vlm prefill/train)
# leaves the JAX package reads in f32 from the f32 master at every use:
# norm scales and LayerNorm biases, the MoE router, the SSM's decay and
# step bias
F32_LEAVES = ("scale", "bias", "router", "A_log", "dt_bias")


# ---------------------------------------------------------------------------
# Pure-SSM LM (Mamba2 stack)
# ---------------------------------------------------------------------------

def _ssm_decls(cfg):
    return {
        "embed": L.decls_embedding(cfg),
        "layers": stack_decls({"ln": L.decls_rmsnorm(cfg.d_model),
                               "block": SSM.decls_mamba2(cfg)},
                              cfg.num_layers),
        "ln_f": L.decls_rmsnorm(cfg.d_model),
    }


def _ssm_forward(params, batch, cfg):
    h = constrain(L.embed(params["embed"], batch["tokens"], cfg, T._cdt(cfg)),
                  "dp", None, None)
    body = T._remat(lambda h, lp: SSM.mamba2_residual(lp, h, cfg), cfg)
    for lp in T._unstack(params["layers"], cfg.num_layers):
        h = body(h, lp)
    return (L.rmsnorm(params["ln_f"], h, cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _ssm_loss(params, batch, cfg):
    h, aux = _ssm_forward(params, batch, cfg)
    loss = L.lm_loss(params["embed"], h, batch["targets"], cfg,
                     batch.get("mask"))
    return loss, {"loss": loss, "aux": aux}


def _ssm_cache_decls(cfg, batch, cache_len):
    d_inner, nheads, N, conv_dim = SSM.ssm_dims(cfg)
    return {
        "ssm": ParamDecl((cfg.num_layers, batch, nheads, cfg.ssm_head_dim, N),
                         torch.float32, (None, "dp", "tp", None, None),
                         "zeros"),
        "conv": ParamDecl((cfg.num_layers, batch, cfg.ssm_conv_width - 1,
                           conv_dim), T._cdt(cfg), (None, "dp", None, "tp"),
                          "zeros"),
    }


def _ssm_prefill(params, batch, cfg):
    """Prompt pass producing final SSM/conv states per layer, written into
    caches allocated once (``layers.write_layer``)."""
    h = constrain(L.embed(params["embed"], batch["tokens"], cfg, T._cdt(cfg)),
                  "dp", None, None)
    caches = L.prefill_caches(_ssm_cache_decls(cfg, *h.shape[:2]), cfg, h)
    for i in range(cfg.num_layers):
        h, fstate, tail = SSM.mamba2_residual_prefill(T._layer(params, i), h,
                                                      cfg)
        L.write_layer(caches["ssm"], i, fstate)
        L.write_layer(caches["conv"], i, tail)
        del fstate, tail
    return T._logits(params, h[:, -1], cfg), caches


def _ssm_decode(params, caches, batch, cfg):
    """One decode step; the states are written into ``caches`` in place."""
    h = L.embed(params["embed"], batch["token"][:, None], cfg, T._cdt(cfg))
    for i in range(cfg.num_layers):
        h = SSM.mamba2_residual_decode(T._layer(params, i), h, cfg, caches, i)
    return T._logits(params, h[:, 0], cfg), caches


# ---------------------------------------------------------------------------
# Model wrapper
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    decls: Any
    loss_fn: Callable
    prefill: Callable
    decode: Callable
    cache_decls_fn: Callable            # (batch, cache_len) -> decls

    def cache_decls(self, batch: int, cache_len: int):
        return self.cache_decls_fn(batch, cache_len)

    # -- dry-run inputs ------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """``meta`` tensors standing in for one shape cell's inputs, their
        logical partition specs, and for decode the cache declarations and
        their ``meta`` tensors: the JAX package's ``input_specs``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        cdt = T._cdt(cfg)

        def sds(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")

        def frontends(batch, specs):
            if cfg.family == "encdec":
                batch["audio_embeds"] = sds((B, cfg.encoder_seq, cfg.d_model),
                                            cdt)
                specs["audio_embeds"] = P("dp", None, None)
            if cfg.family == "vlm":
                vp = min(VISION_PREFIX, S // 4)
                batch["vision_embeds"] = sds((B, vp, cfg.d_model), cdt)
                specs["vision_embeds"] = P("dp", None, None)
                batch["positions"] = sds((3, B, S))
                specs["positions"] = P(None, "dp", None)

        if shape.kind == "train":
            batch = {"tokens": sds((B, S)), "targets": sds((B, S))}
            specs = {"tokens": P("dp", None), "targets": P("dp", None)}
            frontends(batch, specs)
            return {"kind": "train", "batch": batch, "batch_specs": specs}

        if shape.kind == "prefill":
            batch = {"tokens": sds((B, S))}
            specs = {"tokens": P("dp", None)}
            frontends(batch, specs)
            return {"kind": "prefill", "batch": batch, "batch_specs": specs}

        # decode: one new token against a seq_len cache
        batch = {"token": sds((B,)), "pos": sds((B,))}
        specs = {"token": P("dp"), "pos": P("dp")}
        if cfg.family == "vlm":
            batch["positions"] = sds((3, B, 1))
            specs["positions"] = P(None, "dp", None)
        cdecls = self.cache_decls(B, S)
        return {"kind": "decode", "batch": batch, "batch_specs": specs,
                "caches": abstract_params(cdecls), "cache_decls": cdecls}


def build(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return Model(cfg=cfg, decls=T.decls_lm(cfg),
                     loss_fn=lambda p, b: T.loss_fn(p, b, cfg),
                     prefill=lambda p, b: T.prefill(p, b, cfg),
                     decode=lambda p, c, b: T.decode_step(p, c, b, cfg),
                     cache_decls_fn=lambda batch, n: T.cache_decls(cfg, batch,
                                                                   n))
    if fam == "ssm":
        return Model(cfg=cfg, decls=_ssm_decls(cfg),
                     loss_fn=lambda p, b: _ssm_loss(p, b, cfg),
                     prefill=lambda p, b: _ssm_prefill(p, b, cfg),
                     decode=lambda p, c, b: _ssm_decode(p, c, b, cfg),
                     cache_decls_fn=lambda batch, n: _ssm_cache_decls(
                         cfg, batch, n))
    if fam == "hybrid":
        return Model(cfg=cfg, decls=HY.decls_hybrid(cfg),
                     loss_fn=lambda p, b: HY.loss_fn(p, b, cfg),
                     prefill=lambda p, b: HY.prefill(p, b, cfg),
                     decode=lambda p, c, b: HY.decode_step(p, c, b, cfg),
                     cache_decls_fn=lambda batch, n: HY.cache_decls(cfg, batch,
                                                                    n))
    if fam == "encdec":
        return Model(cfg=cfg, decls=ED.decls_encdec(cfg),
                     loss_fn=lambda p, b: ED.loss_fn(p, b, cfg),
                     prefill=lambda p, b: ED.prefill(p, b, cfg),
                     decode=lambda p, c, b: ED.decode_step(p, c, b, cfg),
                     cache_decls_fn=lambda batch, n: ED.cache_decls(cfg, batch,
                                                                    n))
    raise ValueError(f"unknown family {fam!r}")


def compute_params(params, cfg: ModelConfig):
    """The weights in ``cfg.compute_dtype``: the values JAX's
    ``.astype(x.dtype)`` gives at each use, made once.  The leaves JAX
    reads in f32 (``F32_LEAVES``: norm scales, LayerNorm biases, the
    router, ``A_log``, ``dt_bias``) stay as they are; a leaf already in the
    compute dtype is not copied (``Tensor.to``), so a tree drawn in it
    costs nothing."""
    cdt = T._cdt(cfg)

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        return tree if key in F32_LEAVES else tree.to(cdt)
    return cast(params)
