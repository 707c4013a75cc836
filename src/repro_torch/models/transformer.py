"""Decoder-only LM (dense, MoE and VLM): declarations, forward and loss,
block prefill and decode step.

A port of ``src/repro/models/transformer.py``.  The
per-layer declarations are stacked with a leading layer axis, as in JAX,
so parameters carry over by name (``models/convert.py``); JAX's
``lax.scan`` over that axis is a Python loop over the layer index here.
A layer's MLP is ``moe.moe_mlp`` where the config has experts.

  loss_fn(params, batch) -> (loss + 0.01 aux, {"loss", "aux"})  [training]
  prefill(params, batch) -> (last-token logits (B, V) f32, {"k", "v"})
  decode_step(params, caches, batch) -> (logits (B, V) f32, caches)

Training (``forward``) unbinds each stacked leaf once (``_unstack``: its
backward stacks the layers' gradients once, where indexing ``a[i]`` per
layer would allocate a zero gradient of the whole stack per layer and
leaf) and applies ``cfg.remat`` to the layer body (``_remat``): ``"full"``
a non-reentrant ``torch.utils.checkpoint`` a layer, ``"dots"`` a selective
one that keeps the outputs of the matrix products with no batch dims
(``aten.mm``, ``addmm``: the projections and MLPs) and recomputes the
rest, attention (the flash kernel, or its plain version's batched
products) and the MoE's batched expert products included: JAX's
``dots_with_no_batch_dims_saveable``.

The VLM (Qwen2-VL) is this model with M-RoPE: its prefill takes
``vision_embeds (B, VP, D)``, precomputed patch embeddings (the vision
frontend is a stub in both packages) written over the first VP token rows,
and ``positions (3, B, S)``, the (t, h, w) streams; a decode step takes
``positions (3, B, 1)``.  A config without RoPE adds a learned ``pos_emb``
row per position.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import constrain, is_dtensor
from repro_torch.models import layers as L
from repro_torch.models.moe import decls_moe, moe_mlp
from repro_torch.models.params import (ParamDecl, decl, leaves, stack_decls,
                                       tree_map, unflatten)


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
    d = {"embed": L.decls_embedding(cfg),
         "layers": stack_decls(decls_layer(cfg), cfg.num_layers),
         "ln_f": L.decls_rmsnorm(cfg.d_model)}
    if not cfg.use_rope:
        d["pos_emb"] = decl((cfg.max_seq, cfg.d_model), (None, "fsdp"),
                            init="normal", scale=0.02)
    return d


def _cdt(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def table_rows(table, idx):
    """``table[idx]`` with an index past the table clamped to its last row,
    as JAX's gather clamps it."""
    return table[idx.clamp(max=table.shape[0] - 1)]


def _embed_input(params, batch, cfg):
    h = L.embed(params["embed"], batch["tokens"], cfg, _cdt(cfg))
    if "vision_embeds" in batch:
        ve = batch["vision_embeds"]                           # (B, VP, D)
        if is_dtensor(h):     # a sharded slice write has no backward
            h = torch.cat((ve.to(h.dtype), h[:, ve.shape[1]:]), dim=1)
        else:
            h[:, :ve.shape[1]] = ve.to(h.dtype)
    if "pos_emb" in params:
        pe, pos = params["pos_emb"].to(h.dtype), batch.get("positions")
        if pos is not None and pos.dim() == 2:
            h = h + table_rows(pe, pos)                       # (B, S, D)
        else:
            h = h + L.table_prefix(pe, h.shape[1])[None]
    return constrain(h, "dp", None, None)


def _positions(batch, cfg, B, S, device):
    pos = batch.get("positions")
    if pos is None:
        return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    return pos


def _layer(params, i, stack: str = "layers"):
    """Layer ``i``'s parameters: views into the stacked tree."""
    return tree_map(lambda a: a[i], params[stack])


def _unstack(stacked, n: int):
    """The ``n`` layers' parameter trees of a stacked tree, each leaf
    unbound once along its layer axis (for training)."""
    cols = [a.unbind(0) for a in leaves(stacked)]
    return [unflatten(stacked, [c[i] for c in cols]) for i in range(n)]


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots():
    """Selective-checkpoint contexts that keep the outputs of the matrix
    products with no batch dims and recompute every other op."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in _DOTS
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _remat(fn, cfg):
    """``fn`` under ``cfg.remat`` (``"none"``, ``"full"`` or ``"dots"``),
    as JAX's ``_remat``; with grad disabled (serving) ``fn`` runs as it
    is."""
    if cfg.remat not in ("full", "dots"):
        return fn
    extra = {"context_fn": _save_dots} if cfg.remat == "dots" else {}

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **extra)
    return run


def _mlp_residual(lp, h, cfg):
    hn = L.rmsnorm(lp["ln2"], h, cfg.norm_eps)
    m = (moe_mlp(lp["moe"], hn, cfg)[0] if cfg.is_moe
         else L.mlp(lp["mlp"], hn, cfg))
    return h + m


def _logits(params, h, cfg):
    h = L.rmsnorm(params["ln_f"], h, cfg.norm_eps)
    W = L.unembed_matrix(params["embed"], cfg, h.dtype)
    return (h @ W).float()


def layer_fwd(lp, h, cfg, positions):
    """One block (JAX's ``_layer_fwd``): attention, then the MLP (or the
    MoE), each a residual over its RMSNorm.  Returns (h, the MoE's
    auxiliary loss, or None for a dense model)."""
    h = h + L.attention(lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps),
                        cfg, positions)
    hn = L.rmsnorm(lp["ln2"], h, cfg.norm_eps)
    if cfg.is_moe:
        m, a = moe_mlp(lp["moe"], hn, cfg)
        return constrain(h + m, "dp", None, None), a
    return constrain(h + L.mlp(lp["mlp"], hn, cfg), "dp", None, None), None


def pipeline_stage(cfg):
    """The ``layer_fn`` of a pipeline stage (``distributed/pp.py``) of a
    dense model: ``stage(p, h)`` runs the layers of the stacked tree ``p``
    (a leading layer axis) in turn over hidden states h (B, S, D) at
    positions 0..S-1, each ``layer_fwd`` with no remat."""
    def stage(p, h):
        B, S, _ = h.shape
        positions = _positions({}, cfg, B, S, h.device)
        for lp in _unstack(p, leaves(p)[0].shape[0]):
            h = layer_fwd(lp, h, cfg, positions)[0]
        return h
    return stage


def forward(params, batch, cfg):
    """tokens → final hidden states (B, S, D) and the summed MoE auxiliary
    loss (f32; 0 for a dense model)."""
    h = _embed_input(params, batch, cfg)
    B, S, _ = h.shape
    positions = _positions(batch, cfg, B, S, h.device)

    def body(h, aux, lp):
        h, a = layer_fwd(lp, h, cfg, positions)
        return h, aux if a is None else aux + a

    body = _remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in _unstack(params["layers"], cfg.num_layers):
        h, aux = body(h, aux, lp)
    return L.rmsnorm(params["ln_f"], h, cfg.norm_eps), aux


def loss_fn(params, batch, cfg):
    """The training loss: (loss + 0.01 aux, {"loss", "aux"})."""
    h, aux = forward(params, batch, cfg)
    loss = L.lm_loss(params["embed"], h, batch["targets"], cfg,
                     batch.get("mask"))
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def cache_decls(cfg, batch: int, cache_len: int):
    """KV cache: stacked (L, B, T, Hkv, Dh) zeros in the compute dtype."""
    axes = (None, "dp", "kvseq", "kvheads", None)
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": ParamDecl(shape, _cdt(cfg), axes, "zeros"),
            "v": ParamDecl(shape, _cdt(cfg), axes, "zeros")}


def prefill(params, batch, cfg):
    """Forward over the prompt ``batch["tokens"] (B, S)`` (with
    ``vision_embeds`` and ``positions`` for the VLM), returning the last
    token's logits and the KV caches ``(L, B, S, Hkv, Dh)``, allocated
    once and written a layer at a time (``layers.write_layer``)."""
    h = _embed_input(params, batch, cfg)
    B, S, _ = h.shape
    positions = _positions(batch, cfg, B, S, h.device)
    caches = L.prefill_caches(cache_decls(cfg, B, S), cfg, h)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        a, (k, v) = L.attention_prefill(
            lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg, positions)
        L.write_layer(caches["k"], i, k)
        L.write_layer(caches["v"], i, v)
        del k, v
        h = constrain(_mlp_residual(lp, h + a, cfg), "dp", None, None)
    return _logits(params, h[:, -1], cfg), caches


def decode_step(params, caches, batch, cfg):
    """One decode step.  batch: {"token": (B,), "pos": (B,)}, and for M-RoPE
    ``positions (3, B, 1)``.  The new k/v are written into ``caches`` in
    place (``layers.attention_decode``); the same dict is returned."""
    ebatch = {"tokens": batch["token"][:, None]}
    if "positions" in batch:
        ebatch["positions"] = batch["positions"]
    elif "pos_emb" in params:
        ebatch["positions"] = batch["pos"][:, None]
    h = _embed_input(params, ebatch, cfg)
    pos = batch["pos"]
    rope_positions = batch.get("positions") if cfg.mrope_sections else None
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        a, _, _ = L.attention_decode(
            lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg,
            caches["k"][i], caches["v"][i], pos, positions=rope_positions)
        h = _mlp_residual(lp, h + a, cfg)
    return _logits(params, h[:, 0], cfg), caches
