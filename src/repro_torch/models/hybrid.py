"""Zamba2-style hybrid: a Mamba2 backbone and one weight-SHARED attention
block applied after every ``shared_attn_every`` SSM layers.

A port of the serving half of ``src/repro/models/hybrid.py``: the same
grouping of the stack (``_groups``), the same pre-RMSNorm shared block on
the running hidden state, one KV cache per application of it.  JAX's scan
over a group's layers is a Python loop over the layer index.  The shared
block's prefill attention is the ``flash_attention`` kernel
(``layers.attention_prefill``).  ``forward`` and ``loss_fn`` (training) run
the Mamba layers under ``cfg.remat`` and the shared block as it is, as in
JAX.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import constrain

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.params import ParamDecl, stack_decls
from repro_torch.models.transformer import (_cdt, _layer, _logits, _remat,
                                            _unstack)


def n_attn_blocks(cfg) -> int:
    return cfg.num_layers // cfg.shared_attn_every


def _groups(cfg):
    """Static (start, size, has_attn) grouping of the stack."""
    every, n = cfg.shared_attn_every, cfg.num_layers
    out = []
    start = 0
    while start < n:
        size = min(every, n - start)
        out.append((start, size, size == every))
        start += size
    return out


def decls_hybrid(cfg):
    return {
        "embed": L.decls_embedding(cfg),
        "mamba": stack_decls({"ln": L.decls_rmsnorm(cfg.d_model),
                              "block": S.decls_mamba2(cfg)}, cfg.num_layers),
        "shared": {
            "ln1": L.decls_rmsnorm(cfg.d_model),
            "attn": L.decls_attention(cfg),
            "ln2": L.decls_rmsnorm(cfg.d_model),
            "mlp": L.decls_mlp(cfg),
        },
        "ln_f": L.decls_rmsnorm(cfg.d_model),
    }


def cache_decls(cfg, batch: int, cache_len: int):
    d_inner, nheads, N, conv_dim = S.ssm_dims(cfg)
    n_attn = n_attn_blocks(cfg)
    Lyr = cfg.num_layers
    cdt = _cdt(cfg)
    kv = (n_attn, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "ssm": ParamDecl((Lyr, batch, nheads, cfg.ssm_head_dim, N),
                         torch.float32, (None, "dp", "tp", None, None),
                         "zeros"),
        "conv": ParamDecl((Lyr, batch, cfg.ssm_conv_width - 1, conv_dim),
                          cdt, (None, "dp", None, "tp"), "zeros"),
        "k": ParamDecl(kv, cdt, (None, "dp", "kvseq", "kvheads", None),
                       "zeros"),
        "v": ParamDecl(kv, cdt, (None, "dp", "kvseq", "kvheads", None),
                       "zeros"),
    }


def _shared_mlp(sp, h, cfg):
    return constrain(h + L.mlp(sp["mlp"], L.rmsnorm(sp["ln2"], h,
                                                    cfg.norm_eps), cfg),
                     "dp", None, None)


def forward(params, batch, cfg):
    """tokens → final hidden states (B, S, D) and aux 0 (f32)."""
    h = constrain(L.embed(params["embed"], batch["tokens"], cfg, _cdt(cfg)),
                  "dp", None, None)
    B, Ssz, _ = h.shape
    positions = torch.arange(Ssz, dtype=torch.int32,
                             device=h.device)[None].expand(B, Ssz)
    body = _remat(lambda h, lp: S.mamba2_residual(lp, h, cfg), cfg)
    layers = _unstack(params["mamba"], cfg.num_layers)
    for (start, size, has_attn) in _groups(cfg):
        for i in range(start, start + size):
            h = body(h, layers[i])
        if has_attn:
            sp = params["shared"]
            h = h + L.attention(sp["attn"],
                                L.rmsnorm(sp["ln1"], h, cfg.norm_eps), cfg,
                                positions)
            h = _shared_mlp(sp, h, cfg)
    return (L.rmsnorm(params["ln_f"], h, cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=h.device))


def loss_fn(params, batch, cfg):
    h, aux = forward(params, batch, cfg)
    loss = L.lm_loss(params["embed"], h, batch["targets"], cfg,
                     batch.get("mask"))
    return loss, {"loss": loss, "aux": aux}


def prefill(params, batch, cfg):
    """Prompt pass filling the SSM states and the shared block's KV
    caches, each allocated once and written as its layer ends
    (``layers.write_layer``); returns (last-token logits (B, V) f32,
    caches)."""
    h = constrain(L.embed(params["embed"], batch["tokens"], cfg, _cdt(cfg)),
                  "dp", None, None)
    B, Ssz, _ = h.shape
    positions = torch.arange(Ssz, dtype=torch.int32,
                             device=h.device)[None].expand(B, Ssz)
    caches = L.prefill_caches(cache_decls(cfg, B, Ssz), cfg, h)
    gi = 0
    for (start, size, has_attn) in _groups(cfg):
        for i in range(start, start + size):
            h, fstate, tail = S.mamba2_residual_prefill(
                _layer(params, i, "mamba"), h, cfg)
            L.write_layer(caches["ssm"], i, fstate)
            L.write_layer(caches["conv"], i, tail)
            del fstate, tail
        if has_attn:
            sp = params["shared"]
            a, (k, v) = L.attention_prefill(
                sp["attn"], L.rmsnorm(sp["ln1"], h, cfg.norm_eps), cfg,
                positions)
            L.write_layer(caches["k"], gi, k)
            L.write_layer(caches["v"], gi, v)
            del k, v
            h = _shared_mlp(sp, h + a, cfg)
            gi += 1
    return _logits(params, h[:, -1], cfg), caches


def decode_step(params, caches, batch, cfg):
    """One decode step.  batch: {"token": (B,), "pos": (B,)}.  Every cache
    is written in place (``ssm.mamba2_residual_decode``,
    ``layers.attention_decode``); the same dict is returned."""
    h = L.embed(params["embed"], batch["token"][:, None], cfg, _cdt(cfg))
    pos = batch["pos"]
    gi = 0
    for (start, size, has_attn) in _groups(cfg):
        for i in range(start, start + size):
            h = S.mamba2_residual_decode(_layer(params, i, "mamba"), h, cfg,
                                         caches, i)
        if has_attn:
            sp = params["shared"]
            a, _, _ = L.attention_decode(
                sp["attn"], L.rmsnorm(sp["ln1"], h, cfg.norm_eps), cfg,
                caches["k"][gi], caches["v"][gi], pos)
            h = _shared_mlp(sp, h + a, cfg)
            gi += 1
    return _logits(params, h[:, 0], cfg), caches
