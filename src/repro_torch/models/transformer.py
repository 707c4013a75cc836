"""Decoder-only LM (dense and MoE): declarations, block prefill and
decode step.

A port of the serving half of ``src/repro/models/transformer.py``.  The
per-layer declarations are stacked with a leading layer axis, as in JAX,
so parameters carry over by name (``models/convert.py``); JAX's
``lax.scan`` over that axis is a Python loop over the layer index here.
A layer's MLP is ``moe.moe_mlp`` where the config has experts.

  prefill(params, batch) -> (last-token logits (B, V) f32, {"k", "v"})
  decode_step(params, caches, batch) -> (logits (B, V) f32, caches)

The vision prefix and learned position embeddings belong to families the
port does not serve yet (see ``models/api.py``).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.moe import decls_moe, moe_mlp
from repro_torch.models.params import ParamDecl, stack_decls, tree_map


def decls_layer(cfg):
    d = {"ln1": L.decls_rmsnorm(cfg.d_model),
         "attn": L.decls_attention(cfg),
         "ln2": L.decls_rmsnorm(cfg.d_model)}
    if cfg.is_moe:
        d["moe"] = decls_moe(cfg)
    else:
        d["mlp"] = L.decls_mlp(cfg)
    return d


def decls_lm(cfg):
    return {"embed": L.decls_embedding(cfg),
            "layers": stack_decls(decls_layer(cfg), cfg.num_layers),
            "ln_f": L.decls_rmsnorm(cfg.d_model)}


def _cdt(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _embed_input(params, batch, cfg):
    return L.embed(params["embed"], batch["tokens"], cfg, _cdt(cfg))


def _positions(batch, cfg, B, S, device):
    pos = batch.get("positions")
    if pos is None:
        return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    return pos


def _layer(params, i, stack: str = "layers"):
    """Layer ``i``'s parameters: views into the stacked tree."""
    return tree_map(lambda a: a[i], params[stack])


def _mlp_residual(lp, h, cfg):
    hn = L.rmsnorm(lp["ln2"], h, cfg.norm_eps)
    m = (moe_mlp(lp["moe"], hn, cfg)[0] if cfg.is_moe
         else L.mlp(lp["mlp"], hn, cfg))
    return h + m


def _logits(params, h, cfg):
    h = L.rmsnorm(params["ln_f"], h, cfg.norm_eps)
    W = L.unembed_matrix(params["embed"], cfg, h.dtype)
    return (h @ W).float()


def cache_decls(cfg, batch: int, cache_len: int):
    """KV cache: stacked (L, B, T, Hkv, Dh) zeros in the compute dtype."""
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": ParamDecl(shape, _cdt(cfg), "zeros"),
            "v": ParamDecl(shape, _cdt(cfg), "zeros")}


def prefill(params, batch, cfg):
    """Forward over the prompt ``batch["tokens"] (B, S)``, returning the
    last token's logits and the KV caches ``(L, B, S, Hkv, Dh)``."""
    h = _embed_input(params, batch, cfg)
    B, S, _ = h.shape
    positions = _positions(batch, cfg, B, S, h.device)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        a, (k, v) = L.attention_prefill(
            lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg, positions)
        h = _mlp_residual(lp, h + a, cfg)
        ks.append(k)
        vs.append(v)
    return _logits(params, h[:, -1], cfg), {"k": torch.stack(ks),
                                            "v": torch.stack(vs)}


def decode_step(params, caches, batch, cfg):
    """One decode step.  batch: {"token": (B,), "pos": (B,)}.  The new k/v
    are written into ``caches`` in place (``layers.attention_decode``);
    the same dict is returned."""
    h = _embed_input(params, {"tokens": batch["token"][:, None]}, cfg)
    pos = batch["pos"]
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        a, _, _ = L.attention_decode(
            lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg,
            caches["k"][i], caches["v"][i], pos)
        h = _mlp_residual(lp, h + a, cfg)
    return _logits(params, h[:, 0], cfg), caches
