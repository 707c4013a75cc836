"""Transformer building blocks of the LMs, in PyTorch.

Functional ports of ``src/repro/models/layers.py``: every function takes its
parameter dict (declared by the ``decls_*`` functions) and tensors in the JAX
package's layouts, so the two are compared like for like.  Attention is
flat-head: q ``(B, S, H, Dh)``, k/v ``(B, S, Hkv, Dh)``, head h reading kv
head ``h // (H // Hkv)``; RoPE, optional qk-norm (Qwen3), SwiGLU.

Self-attention over a whole sequence (the block prefill) runs the
hand-written ``flash_attention`` kernel; single-token decode against the KV
cache is plain torch, as the JAX package's is jnp outside any Pallas kernel.

Not ported: M-RoPE, layernorm, cross attention and the loss (other families
and training); ``constrain`` (sharding hints) has nothing to do on one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    return {"scale": decl((d,), init="ones")}


def rmsnorm(p, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(dt)


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
    d = {"wq": decl((D, H, Dh)), "wk": decl((D, Hkv, Dh)),
         "wv": decl((D, Hkv, Dh)), "wo": decl((H, Dh, D))}
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
    if cfg.use_rope:
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
    kr, vr = _repeat_kv(cache_k, H), _repeat_kv(cache_v, H)
    scores = torch.einsum("bqhe,bshe->bhqs", q, kr) * (cfg.head_dim ** -0.5)
    scores = scores.float()
    mask = torch.arange(T, device=x.device)[None, :] <= posb[:, None]   # (B,T)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=x.device))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqs,bshe->bqhe", probs, vr)
    y = _proj(out.flatten(2), p["wo"].to(x.dtype).flatten(0, 1))
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP (SwiGLU) and embeddings
# ---------------------------------------------------------------------------

def decls_mlp(cfg):
    D, Fd = cfg.d_model, cfg.d_ff
    return {"w_gate": decl((D, Fd)), "w_up": decl((D, Fd)),
            "w_down": decl((Fd, D))}


def mlp(p, x, cfg):
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (F.silu(g) * u) @ p["w_down"].to(x.dtype)


def decls_embedding(cfg):
    V, D = cfg.vocab_size, cfg.d_model
    d = {"tok": decl((V, D), scale=1.0, init="normal")}
    if not cfg.tie_embeddings:
        d["out"] = decl((D, V))
    return d


def embed(p, tokens, cfg, compute_dtype):
    return p["tok"].to(compute_dtype)[tokens]


def unembed_matrix(p, cfg, dtype):
    if cfg.tie_embeddings:
        return p["tok"].to(dtype).T
    return p["out"].to(dtype)
