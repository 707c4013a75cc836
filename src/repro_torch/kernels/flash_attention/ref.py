"""Plain PyTorch versions of flash attention: the CPU path and the oracle
the CUDA kernel is held against."""
from __future__ import annotations

import torch

NEG = -1e30             # the mask value of the JAX kernel and model


def attention_ref(q, k, v, causal: bool = True, with_lse: bool = False):
    """q/k/v (BH, S, Dh) → (BH, S, Dh) in q's dtype: exact softmax
    attention in f32, the expressions of
    ``src/repro/kernels/flash_attention/ref.py``.  ``with_lse`` also
    returns each row's log-sum-exp of the scaled, masked scores (BH, S)
    f32, in natural log: what the backward reads."""
    BH, S, Dh = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (Dh ** -0.5)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None], s, torch.full((), NEG, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    if with_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _repeat_heads(q, k, v):
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    return k, v


def flash_attention_ref(q, k, v, causal: bool = True, with_lse: bool = False):
    """The wrapper's function in plain PyTorch: q (B, S, H, Dh), k/v
    (B, S, Hkv, Dh) → (B, S, H, Dh), head h reading kv head
    h // (H // Hkv); kv is repeated, heads folded into the batch, and
    ``attention_ref`` applied.  ``with_lse`` also returns the rows'
    log-sum-exp, (B, H, S) f32."""
    B, S, H, Dh = q.shape
    k, v = _repeat_heads(q, k, v)

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, S, Dh)
    out = attention_ref(fold(q), fold(k), fold(v), causal, with_lse)
    out, lse = out if with_lse else (out, None)
    out = out.reshape(B, H, S, Dh).transpose(1, 2).contiguous()
    return (out, lse.reshape(B, H, S)) if with_lse else out


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True):
    """The backward of ``flash_attention`` in plain PyTorch, in f32: q, o,
    do (B, S, H, Dh), k/v (B, S, Hkv, Dh), lse (B, H, S) the forward's
    log-sum-exp → (dq, dk, dv) in the inputs' dtypes.

    P = exp(S·scale − lse) is recomputed, then D = rowsum(dO∘O),
    dV = Pᵀ dO, dS = P∘(dO Vᵀ − D), dQ = dS K·scale, dK = dSᵀ Q·scale.
    Under GQA, dK and dV of a kv head sum its G = H / Hkv query heads in
    ascending head order."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = Dh ** -0.5
    kr, vr = _repeat_heads(q, k, v)

    def heads(x):                                   # (B, S, h, Dh) → (B, h, S, Dh)
        return x.float().transpose(1, 2)
    qf, kf, vf, of, dof = (heads(t) for t in (q, kr, vr, o, do))
    s = qf @ kf.transpose(-1, -2) * scale
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, torch.full((), NEG, device=q.device))
    p = torch.exp(s - lse.float()[..., None])
    d = (dof * of).sum(-1, keepdim=True)
    dv_h = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - d)
    dq = ds @ kf * scale
    dk_h = ds.transpose(-1, -2) @ qf * scale

    def by_kv_head(x):                              # (B, H, S, Dh) → (B, S, Hkv, Dh)
        x = x.view(B, Hkv, G, S, Dh)
        acc = x[:, :, 0]
        for g in range(1, G):
            acc = acc + x[:, :, g]
        return acc.transpose(1, 2)
    return (dq.transpose(1, 2).to(q.dtype).contiguous(),
            by_kv_head(dk_h).to(k.dtype).contiguous(),
            by_kv_head(dv_h).to(v.dtype).contiguous())


BF16_U = 2.0 ** -8      # unit roundoff of bf16


def bf16_excess(out, q, k, v, causal: bool = True, rtol: float = 1e-2,
                row_rtol: float = 1e-2):
    """How far a bf16 output ``out`` of the wrapper's function lies from the
    exact attention in f32, as fractions of two bounds; ``out`` agrees when
    both are at most 1.

    Element: ``|out - ref| <= rtol |ref| + BF16_U (P |v|)``.  A kernel that
    rounds P to bf16 before P.V (as the CUDA kernel and the JAX model do)
    moves each output by at most ``BF16_U sum_j p_j |v_j|``; ``rtol`` covers
    the rounding of the output itself (``BF16_U`` relative).  Unlike a fixed
    atol, the bound shrinks with the output of a long row (|out| ~ S^-1/2).

    Row: ``||out - ref|| <= row_rtol ||ref||`` over the head dim of each
    (batch, position, head).  Rounding noise stays near ``BF16_U`` relative
    here at every length, while a dropped key tile or a wrong normaliser
    moves a whole row."""
    q, k, v = q.float(), k.float(), v.float()
    ref = flash_attention_ref(q, k, v, causal)
    ref_abs = flash_attention_ref(q, k, v.abs(), causal)
    diff = out.float() - ref
    elem = diff.abs() / (rtol * ref.abs() + BF16_U * ref_abs).clamp_min(1e-30)
    row = diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    return float(elem.max()), float(row.max()) / row_rtol
