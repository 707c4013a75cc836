"""Whisper-style encoder-decoder: declarations, encoder, block prefill and
decode step.

A port of ``src/repro/models/encdec.py``.
The conv/mel audio frontend is a stub in both packages: ``audio_embeds``
are precomputed frame embeddings ``(B, encoder_seq, D)``.  The rest is the
reference's: a bidirectional encoder, a causal decoder with cross
attention, learned position embeddings, pre-LN LayerNorm and a GELU MLP.
JAX's ``lax.scan`` over the stacked layer axis is a Python loop here.

The encoder's self-attention runs ``flash_attention(causal=False)`` and the
decoder prefill's runs it causal (``layers.attention_prefill``); the decode
step's self-attention and all cross attention are plain torch.

  loss_fn(params, {"audio_embeds", "tokens", "targets"}) -> (loss, metrics)
  encode(params, audio_embeds) -> encoder output (B, encoder_seq, D)
  prefill(params, {"audio_embeds", "tokens"}) -> (logits (B, V) f32,
                                                  {"k", "v", "xk", "xv"})
  decode_step(params, caches, {"token", "pos"}) -> (logits, caches)
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import constrain

from repro_torch.models import layers as L
from repro_torch.models.params import ParamDecl, decl, stack_decls
from repro_torch.models.transformer import (_cdt, _layer, _remat, _unstack,
                                            table_rows)


def decls_encdec(cfg):
    enc_layer = {
        "ln1": L.decls_layernorm(cfg.d_model),
        "attn": L.decls_attention(cfg),
        "ln2": L.decls_layernorm(cfg.d_model),
        "mlp": L.decls_mlp(cfg),
    }
    dec_layer = {
        "ln1": L.decls_layernorm(cfg.d_model),
        "attn": L.decls_attention(cfg),
        "ln_x": L.decls_layernorm(cfg.d_model),
        "xattn": L.decls_attention(cfg),
        "ln2": L.decls_layernorm(cfg.d_model),
        "mlp": L.decls_mlp(cfg),
    }
    return {
        "embed": L.decls_embedding(cfg),
        "pos_enc": decl((cfg.encoder_seq, cfg.d_model), (None, "fsdp"),
                        init="normal", scale=0.02),
        "pos_dec": decl((cfg.max_seq, cfg.d_model), (None, "fsdp"),
                        init="normal", scale=0.02),
        "encoder": stack_decls(enc_layer, cfg.encoder_layers),
        "decoder": stack_decls(dec_layer, cfg.num_layers),
        "ln_enc": L.decls_layernorm(cfg.d_model),
        "ln_f": L.decls_layernorm(cfg.d_model),
    }


def _ln(p, x, cfg):
    return L.layernorm(p, x, cfg.norm_eps)


def _mlp_residual(lp, h, cfg):
    return h + L.mlp(lp["mlp"], _ln(lp["ln2"], h, cfg), cfg)


def encode(params, audio_embeds, cfg):
    """audio_embeds (B, S_enc, D), the stubbed frontend's output; the layer
    body under ``cfg.remat`` when training."""
    h = audio_embeds.to(_cdt(cfg))
    h = constrain(h + L.table_prefix(params["pos_enc"].to(h.dtype),
                                     h.shape[1])[None], "dp", None, None)

    def body(h, lp):
        h = h + L.attention(lp["attn"], _ln(lp["ln1"], h, cfg), cfg,
                            causal=False)
        return constrain(_mlp_residual(lp, h, cfg), "dp", None, None)
    body = _remat(body, cfg)
    for lp in _unstack(params["encoder"], cfg.encoder_layers):
        h = body(h, lp)
    return _ln(params["ln_enc"], h, cfg)


def _embed_dec(params, tokens, cfg):
    h = L.embed(params["embed"], tokens, cfg, _cdt(cfg))
    return constrain(h + L.table_prefix(params["pos_dec"].to(h.dtype),
                                        tokens.shape[1])[None],
                     "dp", None, None)


def _cross_residual(lp, h, kv, cfg):
    return h + L.attention_cross(lp["xattn"], _ln(lp["ln_x"], h, cfg), kv,
                                 cfg)


def _logits(params, h, cfg):
    h = _ln(params["ln_f"], h, cfg)
    return (h @ L.unembed_matrix(params["embed"], cfg, h.dtype)).float()


def _decoder_fwd(params, tokens, enc_out, cfg):
    """The teacher-forced decoder: final hidden states (B, S, D); the
    layer body under ``cfg.remat`` when training."""
    h = _embed_dec(params, tokens, cfg)

    def body(h, lp):
        h = h + L.attention(lp["attn"], _ln(lp["ln1"], h, cfg), cfg,
                            causal=True)
        h = _cross_residual(lp, h, L.cross_kv(lp["xattn"], enc_out, cfg), cfg)
        return constrain(_mlp_residual(lp, h, cfg), "dp", None, None)
    body = _remat(body, cfg)
    for lp in _unstack(params["decoder"], cfg.num_layers):
        h = body(h, lp)
    return _ln(params["ln_f"], h, cfg)


def loss_fn(params, batch, cfg):
    enc_out = encode(params, batch["audio_embeds"], cfg)
    h = _decoder_fwd(params, batch["tokens"], enc_out, cfg)
    loss = L.lm_loss(params["embed"], h, batch["targets"], cfg,
                     batch.get("mask"))
    return loss, {"loss": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=h.device)}


def cache_decls(cfg, batch: int, cache_len: int):
    """Self-attention k/v ``(L, B, T, Hkv, Dh)`` and the cross-attention
    ``xk``/``xv`` ``(L, B, encoder_seq, Hkv, Dh)``, zeros in the compute
    dtype."""
    Hkv, Dh, Lyr, cdt = (cfg.num_kv_heads, cfg.head_dim, cfg.num_layers,
                         _cdt(cfg))
    self_kv = (Lyr, batch, cache_len, Hkv, Dh)
    cross = (Lyr, batch, cfg.encoder_seq, Hkv, Dh)
    self_axes = (None, "dp", "kvseq", "kvheads", None)
    cross_axes = (None, "dp", None, "kvheads", None)
    return {"k": ParamDecl(self_kv, cdt, self_axes, "zeros"),
            "v": ParamDecl(self_kv, cdt, self_axes, "zeros"),
            "xk": ParamDecl(cross, cdt, cross_axes, "zeros"),
            "xv": ParamDecl(cross, cdt, cross_axes, "zeros")}


def prefill(params, batch, cfg):
    """Encode ``audio_embeds`` and run the decoder over ``tokens (B, S)``,
    building every cache (allocated once, written a layer at a time,
    ``layers.write_layer``): the last token's logits and ``{"k", "v",
    "xk", "xv"}``."""
    enc_out = encode(params, batch["audio_embeds"], cfg)
    h = _embed_dec(params, batch["tokens"], cfg)
    caches = L.prefill_caches(cache_decls(cfg, *h.shape[:2]), cfg, h)
    for i in range(cfg.num_layers):
        lp = _layer(params, i, "decoder")
        a, (k, v) = L.attention_prefill(lp["attn"], _ln(lp["ln1"], h, cfg),
                                        cfg, causal=True)
        xk, xv = L.cross_kv(lp["xattn"], enc_out, cfg)
        L.write_layer(caches["k"], i, k)
        L.write_layer(caches["v"], i, v)
        # the cross attention reads the slots, placed as the projection's
        # K and V, or those where the declarations place the cache apart
        kv = (L.write_layer(caches["xk"], i, xk),
              L.write_layer(caches["xv"], i, xv))
        del k, v, xk, xv
        h = _cross_residual(lp, h + a, kv, cfg)
        del kv
        h = constrain(_mlp_residual(lp, h, cfg), "dp", None, None)
    return _logits(params, h[:, -1], cfg), caches


def decode_step(params, caches, batch, cfg):
    """One decode step.  batch: {"token": (B,), "pos": (B,)}.  The new
    self-attention k/v are written into ``caches`` in place; ``xk``/``xv``
    are read as they are.  The same dict is returned."""
    B = batch["token"].shape[0]
    pos = batch["pos"]
    h = L.embed(params["embed"], batch["token"][:, None], cfg, _cdt(cfg))
    posb = torch.as_tensor(pos, device=h.device).to(torch.int64).expand(B)
    h = h + table_rows(params["pos_dec"].to(h.dtype), posb)[:, None, :]
    for i in range(cfg.num_layers):
        lp = _layer(params, i, "decoder")
        a, _, _ = L.attention_decode(lp["attn"], _ln(lp["ln1"], h, cfg), cfg,
                                     caches["k"][i], caches["v"][i], pos)
        h = _cross_residual(lp, h + a, (caches["xk"][i], caches["xv"][i]),
                            cfg)
        h = _mlp_residual(lp, h, cfg)
    return _logits(params, h[:, 0], cfg), caches
