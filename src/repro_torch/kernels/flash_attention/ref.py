"""Plain PyTorch versions of flash attention: the CPU path and the oracle
the CUDA kernel is held against."""
from __future__ import annotations

import torch

NEG = -1e30             # the mask value of the JAX kernel and model


def attention_ref(q, k, v, causal: bool = True):
    """q/k/v (BH, S, Dh) → (BH, S, Dh) in q's dtype: exact softmax
    attention in f32, the expressions of
    ``src/repro/kernels/flash_attention/ref.py``."""
    BH, S, Dh = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (Dh ** -0.5)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None], s, torch.full((), NEG, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_ref(q, k, v, causal: bool = True):
    """The wrapper's function in plain PyTorch: q (B, S, H, Dh), k/v
    (B, S, Hkv, Dh) → (B, S, H, Dh), head h reading kv head
    h // (H // Hkv); kv is repeated, heads folded into the batch, and
    ``attention_ref`` applied."""
    B, S, H, Dh = q.shape
    group = H // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, S, Dh)
    out = attention_ref(fold(q), fold(k), fold(v), causal)
    return out.reshape(B, H, S, Dh).transpose(1, 2).contiguous()


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
