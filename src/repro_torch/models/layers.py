"""Transformer building blocks of the LMs, in PyTorch.

Functional ports of ``src/repro/models/layers.py``: every function takes its
parameter dict (declared by the ``decls_*`` functions) and tensors in the JAX
package's layouts, so the two are compared like for like.  Attention is
flat-head: q ``(B, S, H, Dh)``, k/v ``(B, S, Hkv, Dh)``, head h reading kv
head ``h // (H // Hkv)``; RMSNorm and LayerNorm, RoPE, M-RoPE (Qwen2-VL)
and NoPE, optional qk-norm (Qwen3), SwiGLU, GELU and relu² MLPs.

Self-attention over a whole sequence (the block prefill, causal or not)
runs the hand-written ``flash_attention`` kernel; single-token decode
against the KV cache and cross attention against an encoder's k/v are plain
torch, as the JAX package's are jnp outside any Pallas kernel (its kernel
takes only Sq = Skv, and so does the port's).

Training: ``attention`` is differentiable (``flash_attention`` goes through
its ``torch.autograd.Function`` when an input requires grad: the forward
kernel, then the hand-written backward kernel), and the loss is
``lm_loss`` over ``softmax_xent``, chunked over the sequence with one
``torch.utils.checkpoint`` a chunk where ``cfg.loss_chunk`` asks (JAX's
``jax.checkpoint``).  ``constrain`` (sharding hints) has nothing to do on
one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.params import decl

NEG_INF = -1e30


def _proj(x, w):
    """x (..., D) against w (D, *out) → (..., *out): JAX's
    ``einsum("...d,d...->...")`` as one contiguous matrix product."""
    return (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


# ---------------------------------------------------------------------------
# Norms and rotary position embeddings
# ---------------------------------------------------------------------------

def decls_rmsnorm(d):
    return {"scale": decl((d,), (None,), init="ones")}


def rmsnorm(p, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(dt)


def decls_layernorm(d):
    return {"scale": decl((d,), (None,), init="ones"),
            "bias": decl((d,), (None,), init="zeros")}


def layernorm(p, x, eps=1e-5):
    """In f32 with the population variance, ``scale`` and ``bias`` read in
    f32 (JAX's ``layernorm``); every caller passes ``cfg.norm_eps``."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p["scale"].float() + p["bias"].float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x (..., S, H, Dh); positions broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (Dh/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, Dh/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_angles(positions, freqs, sections):
    """positions (3, ..., S), freqs (Dh/2,) → angles (..., S, Dh/2):
    frequency slot f reads the (t | h | w) stream its section assigns
    (``sections``: half-dim sizes summing to Dh/2).  JAX selects the stream
    with a one-hot einsum (``x·1 + y·0 + z·0``, exact in f32); the gather
    here gives the same angles bit for bit."""
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=freqs.device),
        torch.tensor(sections, device=freqs.device),
        output_size=sum(sections))                               # (Dh/2,)
    return positions.float()[sec_id].movedim(0, -1) * freqs


def apply_mrope(x, positions, theta: float, sections):
    """M-RoPE (Qwen2-VL): x (B, S, H, Dh), positions (3, B, S), the (t, h, w)
    streams."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (Dh/2,)
    ang = mrope_angles(positions, freqs, sections)              # (B, S, Dh/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def padded_heads(cfg, axis: int = 16) -> int:
    """Flat q-head count after per-kv-group zero padding (``pad_head_groups``:
    the smallest Hkv·Gp ≥ H divisible by ``axis``); H otherwise.  Padded
    heads have zero wq/wo slices, so the function is the unpadded model's."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    if not getattr(cfg, "pad_head_groups", False) or Hkv == 0 or H % axis == 0:
        return H
    gp = H // Hkv
    while (Hkv * gp) % axis != 0:
        gp += 1
    return Hkv * gp


def eff_heads(cfg) -> int:
    return padded_heads(cfg)


def decls_attention(cfg):
    D, Hkv, Dh = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    H = eff_heads(cfg)
    d = {"wq": decl((D, H, Dh), ("fsdp", "qheads", None)),
         "wk": decl((D, Hkv, Dh), ("fsdp", "tp_kv", None)),
         "wv": decl((D, Hkv, Dh), ("fsdp", "tp_kv", None)),
         "wo": decl((H, Dh, D), ("qheads", None, "fsdp"))}
    if cfg.qk_norm:
        d["q_norm"] = decls_rmsnorm(Dh)
        d["k_norm"] = decls_rmsnorm(Dh)
    return d


def _project_qkv(p, x, cfg, positions):
    """x (B,S,D) → q (B,S,H,Dh), k/v (B,S,Hkv,Dh), rope applied."""
    q = _proj(x, p["wq"].to(x.dtype))
    k = _proj(x, p["wk"].to(x.dtype))
    v = _proj(x, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.use_rope and cfg.mrope_sections:
        if positions.dim() != x.dim():
            raise ValueError(f"M-RoPE needs positions (3, B, S), the (t, h, "
                             f"w) streams; got {tuple(positions.shape)}")
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k, H):
    """(B,S,Hkv,Dh) → (B,S,H,Dh); head h uses kv head h // (H//Hkv)."""
    Hkv = k.shape[2]
    if Hkv == H:
        return k
    return k.repeat_interleave(H // Hkv, dim=2)


def _attend_seq(q, k, v, cfg, causal):
    """Self-attention over the whole sequence: the function the JAX
    package's ``_attend_seq`` computes with ``_repeat_kv`` + ``_attend``,
    plain or q-chunked (``attn_chunk`` only splits that function), here in
    one ``flash_attention`` launch, with kv heads indexed rather than
    repeated.  The scale is ``head_dim ** -0.5`` in both."""
    return flash_attention(q, k, v, causal)


def _default_positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)


def attention_prefill(p, x, cfg, positions=None, *, causal=True):
    """Full-sequence attention; returns ``(y (B,S,D), (k, v))``, the k/v
    of the cache."""
    if positions is None:
        positions = _default_positions(x)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = _attend_seq(q, k, v, cfg, causal)
    y = _proj(out.flatten(2), p["wo"].to(x.dtype).flatten(0, 1))
    return y, (k, v)


def attention(p, x, cfg, positions=None, *, causal=True):
    """Full-sequence attention (B,S,D) → (B,S,D)."""
    return attention_prefill(p, x, cfg, positions, causal=causal)[0]


def attention_decode(p, x, cfg, cache_k, cache_v, pos, positions=None):
    """Single-token decode.

    x (B,1,D); cache_k/v (B,T,Hkv,Dh) with valid entries < pos; pos (B,).
    The new k/v are written into the caches IN PLACE at ``pos`` (the JAX
    function returns updated copies; a copy of a full-width cache per layer
    and step is what the in-place write saves); a position ≥ T is dropped,
    as JAX's ``mode="drop"`` drops it.  Returns (y (B,1,D), cache_k,
    cache_v).
    """
    B, T = x.shape[0], cache_k.shape[1]
    H = eff_heads(cfg)
    posb = torch.as_tensor(pos, device=x.device).to(torch.int64).expand(B)
    if positions is None:
        positions = posb[:, None]
    q, k, v = _project_qkv(p, x, cfg, positions)
    # the write needs no host sync: a dropped position rewrites its own value
    keep = (posb < T)[:, None, None]
    bidx = torch.arange(B, device=x.device)
    at = posb.clamp(max=T - 1)
    cache_k[bidx, at] = torch.where(keep, k[:, 0], cache_k[bidx, at])
    cache_v[bidx, at] = torch.where(keep, v[:, 0], cache_v[bidx, at])
    mask = torch.arange(T, device=x.device)[None, :] <= posb[:, None]   # (B,T)
    out = _attend(q, _repeat_kv(cache_k, H), _repeat_kv(cache_v, H), cfg,
                  mask[:, None, None, :])
    y = _proj(out.flatten(2), p["wo"].to(x.dtype).flatten(0, 1))
    return y, cache_k, cache_v


def _attend(q, k, v, cfg, mask=None):
    """Plain attention, q (B,Sq,H,Dh) against k/v (B,Skv,H,Dh): scores in
    q's dtype, scaled, then softmax in f32 (masked where ``mask``, which
    broadcasts to (B,H,Sq,Skv), is False)."""
    scores = torch.einsum("bqhe,bshe->bhqs", q, k) * (cfg.head_dim ** -0.5)
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshe->bqhe", probs, v)


def attention_cross(p, x, enc_kv, cfg):
    """Cross attention of x (B, Sq, D) against an encoder's precomputed
    ``(k, v)`` (B, Skv, Hkv, Dh), unmasked; plain torch, as the decode
    step's."""
    k, v = enc_kv
    q = _proj(x, p["wq"].to(x.dtype))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
    H = eff_heads(cfg)
    out = _attend(q, _repeat_kv(k, H), _repeat_kv(v, H), cfg)
    return _proj(out.flatten(2), p["wo"].to(x.dtype).flatten(0, 1))


def cross_kv(p, enc_out, cfg):
    """The encoder output (B, Skv, D) → cross-attention (k, v)."""
    k = _proj(enc_out, p["wk"].to(enc_out.dtype))
    v = _proj(enc_out, p["wv"].to(enc_out.dtype))
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


# ---------------------------------------------------------------------------
# MLP (SwiGLU, GELU, relu²) and embeddings
# ---------------------------------------------------------------------------

def decls_mlp(cfg):
    D, Fd = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"w_gate": decl((D, Fd), ("fsdp", "tp")),
                "w_up": decl((D, Fd), ("fsdp", "tp")),
                "w_down": decl((Fd, D), ("tp", "fsdp"))}
    return {"w_up": decl((D, Fd), ("fsdp", "tp")),
            "w_down": decl((Fd, D), ("tp", "fsdp"))}


def mlp(p, x, cfg):
    if "w_gate" in p:
        g = x @ p["w_gate"].to(x.dtype)
        u = x @ p["w_up"].to(x.dtype)
        h = F.silu(g) * u
    else:
        h = x @ p["w_up"].to(x.dtype)
        # jax.nn.gelu's default is the tanh form
        h = (F.gelu(h, approximate="tanh") if cfg.mlp_type == "gelu"
             else F.relu(h).square())
    return h @ p["w_down"].to(x.dtype)


def decls_embedding(cfg):
    V, D = cfg.vocab_size, cfg.d_model
    d = {"tok": decl((V, D), ("vocab", "fsdp"), scale=1.0, init="normal")}
    if not cfg.tie_embeddings:
        d["out"] = decl((D, V), ("fsdp", "vocab"))
    return d


def embed(p, tokens, cfg, compute_dtype):
    return p["tok"].to(compute_dtype)[tokens]


def unembed_matrix(p, cfg, dtype):
    if cfg.tie_embeddings:
        return p["tok"].to(dtype).T
    return p["out"].to(dtype)


# ---------------------------------------------------------------------------
# Loss: cross-entropy over the unembedding, chunked over the sequence
# ---------------------------------------------------------------------------

def _nll(logits, targets):
    """Each token's negative log-likelihood in f32: lse - gold."""
    logits = logits.float()
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def softmax_xent(logits, targets, mask=None):
    """logits (..., V); targets (...) int; the mean negative log-likelihood
    over valid tokens, in f32."""
    nll = _nll(logits, targets)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _chunk_nll(hc, W, tc, mc):
    """One chunk's (sum of nll, token count) in f32."""
    nll = _nll(hc @ W, tc)
    if mc is None:
        return torch.sum(nll), torch.tensor(float(nll.numel()),
                                            dtype=torch.float32,
                                            device=nll.device)
    return torch.sum(nll * mc), torch.sum(mc)


def lm_loss(p_emb, h, targets, cfg, mask=None):
    """Final hidden states (B, S, D) → the mean cross-entropy.  With
    ``cfg.loss_chunk`` > 0 dividing S (and below it), the sequence is cut
    into chunks whose logits are recomputed in the backward
    (``torch.utils.checkpoint`` a chunk, JAX's ``jax.checkpoint``), so only
    (B, loss_chunk, V) logits live at a time; the sums add chunk by chunk
    in order, as JAX's scan does."""
    W = unembed_matrix(p_emb, cfg, h.dtype)                   # (D, V)
    B, S, _ = h.shape
    chunk = cfg.loss_chunk
    if not chunk or S <= chunk or S % chunk != 0:
        return softmax_xent(h @ W, targets, mask)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        s, n = checkpoint(_chunk_nll, h[:, sl], W, targets[:, sl],
                          None if mask is None else mask[:, sl],
                          use_reentrant=False)
        tot = tot + s
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)
