"""Mamba2 (SSD, state-space duality) block in PyTorch.

A port of ``src/repro/models/ssm.py``.  The prompt runs the chunked SSD
algorithm: within a chunk a quadratic, attention-like product; across
chunks a linear recurrence over the (nheads, P, N) state, JAX's
``lax.scan`` as a Python loop over the chunks.  Decode is the one-step
recurrence over that state plus a rolling causal-conv buffer.  As in JAX:
ngroups = 1 (B and C shared across heads), the SSD internals in f32,
``A_log`` and ``dt_bias`` read in f32.

``mamba2_prefill`` is the prompt pass of one block with the final state
and conv tail the decode cache starts from (the body that JAX's
``_ssm_prefill`` and ``hybrid.prefill`` each write inline);
``mamba2_block`` is its output alone.  The ``*_residual`` functions are
one layer of the Mamba2 stacks of ``models/api.py`` and
``models/hybrid.py``: pre-RMSNorm, the block, the residual add.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain

from repro_torch.models.layers import decls_rmsnorm, rmsnorm
from repro_torch.models.params import decl


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N            # conv over [x, B, C]
    return d_inner, nheads, N, conv_dim


def decls_mamba2(cfg):
    D = cfg.d_model
    d_inner, nheads, N, conv_dim = ssm_dims(cfg)
    # in_proj → [z (d_inner), x (d_inner), B (N), C (N), dt (nheads)]
    return {
        "in_proj": decl((D, 2 * d_inner + 2 * N + nheads), ("fsdp", "tp")),
        "conv_w": decl((cfg.ssm_conv_width, conv_dim), (None, "tp")),
        "conv_b": decl((conv_dim,), ("tp",), init="zeros"),
        "A_log": decl((nheads,), ("tp",), init="zeros"),
        "D": decl((nheads,), ("tp",), init="ones"),
        "dt_bias": decl((nheads,), ("tp",), init="zeros"),
        "norm": decls_rmsnorm(d_inner),
        "out_proj": decl((d_inner, D), ("tp", "fsdp")),
    }


def _split_proj(cfg, zxbcdt):
    d_inner, nheads, N, _ = ssm_dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * N]
    dt = zxbcdt[..., -nheads:]
    return z, xbc, dt


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _segsum(a):
    """a (..., L) → (..., L, L) with out[i,j] = sum_{j<k<=i} a[k], -inf above diag."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, ss, torch.full((), -torch.inf, device=a.device))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """SSD forward.

    x (B,S,nh,P); dt (B,S,nh) post-softplus; A (nh,) negative;
    Bm/Cm (B,S,N) shared across heads.  Returns (y (B,S,nh,P),
    final_state (B,nh,P,N) f32).
    """
    Bsz, S, nh, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    assert S % chunk == 0, (S, chunk)

    xc = x.reshape(Bsz, nc, chunk, nh, P)
    dtc = dt.reshape(Bsz, nc, chunk, nh).float()
    bc = Bm.reshape(Bsz, nc, chunk, N)
    cc = Cm.reshape(Bsz, nc, chunk, N)

    dA = (dtc * A).movedim(-1, 1)                          # (B,nh,nc,L) ≤ 0
    A_cum = torch.cumsum(dA, dim=-1)                       # (B,nh,nc,L)

    # ---- intra-chunk (diagonal blocks) ----
    Lmat = torch.exp(_segsum(dA))                          # (B,nh,nc,L,L)
    scores = cc @ bc.transpose(-1, -2)                     # (B,nc,L,L)
    xdt = xc.float() * dtc[..., None]                      # (B,nc,L,nh,P)
    xdt_h = xdt.permute(0, 3, 1, 2, 4)                     # (B,nh,nc,L,P)
    y_diag = (scores.float()[:, None] * Lmat) @ xdt_h      # (B,nh,nc,L,P)

    # ---- chunk states ----
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)      # (B,nh,nc,L)
    states = ((xdt_h * decay_states[..., None]).transpose(-1, -2)
              @ bc.float()[:, None])                       # (B,nh,nc,P,N)

    # ---- inter-chunk recurrence (sequential over chunks) ----
    chunk_decay = torch.exp(A_cum[..., -1])                # (B,nh,nc)
    carry = (torch.zeros((Bsz, nh, P, N), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    prev = []                                              # state *entering* chunk
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, :, c]
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,nh,P,N)

    # ---- state → output ----
    out_decay = torch.exp(A_cum).permute(0, 2, 1, 3)       # (B,nc,nh,L)
    y_off = ((cc.float()[:, :, None] @ prev_states.transpose(-1, -2))
             * out_decay[..., None])                       # (B,nc,nh,L,P)
    y = y_diag.permute(0, 2, 3, 1, 4) + y_off.permute(0, 1, 3, 2, 4)
    return y.reshape(Bsz, S, nh, P).to(x.dtype), carry


def _causal_conv(xbc, w, b):
    """Depthwise causal conv: xbc (B,S,Cd), w (K,Cd), b (Cd)."""
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i][None, None, :]
              for i in range(K))
    return F.silu(out + b[None, None, :])


def mamba2_prefill(p, h, cfg):
    """Full-sequence forward of one block: h (B,S,D) → (y (B,S,D), the
    final SSM state (B,nh,P,N) f32, the conv tail (B,K-1,Cd): the inputs
    of the last K-1 positions, before the conv)."""
    d_inner, nheads, N, conv_dim = ssm_dims(cfg)
    B, S, D = h.shape
    zxbcdt = h @ p["in_proj"].to(h.dtype)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    conv_tail = xbc[:, -(cfg.ssm_conv_width - 1):, :]
    xbc = _causal_conv(xbc, p["conv_w"].to(h.dtype), p["conv_b"].to(h.dtype))
    xin = xbc[..., :d_inner].reshape(B, S, nheads, cfg.ssm_head_dim)
    xin = constrain(xin, "dp", None, "tp", None)
    Bm = xbc[..., d_inner:d_inner + N]
    Cm = xbc[..., d_inner + N:]
    dt = _softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, fstate = ssd_chunked(xin, dt, A, Bm, Cm, min(cfg.ssm_chunk, S))
    y = y + xin * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, d_inner) * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return y @ p["out_proj"].to(h.dtype), fstate, conv_tail


def mamba2_block(p, h, cfg):
    """Full-sequence forward: h (B,S,D) → (B,S,D)."""
    return mamba2_prefill(p, h, cfg)[0]


def mamba2_residual(lp, h, cfg):
    """One layer of a Mamba2 stack over a whole sequence (training):
    h + block(rmsnorm(h))."""
    return constrain(h + mamba2_block(lp["block"],
                                      rmsnorm(lp["ln"], h, cfg.norm_eps), cfg),
                     "dp", None, None)


def mamba2_residual_prefill(lp, h, cfg):
    """One layer of a Mamba2 stack over the prompt: ``lp`` holds ``ln``
    and ``block``.  Returns (h + block(rmsnorm(h)), final state, conv
    tail)."""
    y, fstate, tail = mamba2_prefill(lp["block"],
                                     rmsnorm(lp["ln"], h, cfg.norm_eps), cfg)
    return constrain(h + y, "dp", None, None), fstate, tail


# ---------------------------------------------------------------------------
# Decode (single token, O(1) state)
# ---------------------------------------------------------------------------

def mamba2_cache_shape(cfg, batch: int):
    d_inner, nheads, N, conv_dim = ssm_dims(cfg)
    return {
        "ssm": (batch, nheads, cfg.ssm_head_dim, N),        # f32
        "conv": (batch, cfg.ssm_conv_width - 1, conv_dim),  # compute dtype
    }


def mamba2_decode(p, h, cfg, cache):
    """h (B,1,D); cache {"ssm": (B,nh,P,N) f32, "conv": (B,K-1,Cd)}.
    Returns (y (B,1,D), the new cache); ``cache`` is not written."""
    d_inner, nheads, N, conv_dim = ssm_dims(cfg)
    B = h.shape[0]
    P = cfg.ssm_head_dim
    zxbcdt = h @ p["in_proj"].to(h.dtype)
    z, xbc, dt = _split_proj(cfg, zxbcdt)                   # xbc (B,1,Cd)
    # rolling conv buffer
    window = torch.cat([cache["conv"], xbc], dim=1)         # (B,K,Cd)
    new_conv = window[:, 1:, :]
    w = p["conv_w"].to(h.dtype)
    conv_out = (window * w).sum(1) + p["conv_b"].to(h.dtype)
    xbc1 = F.silu(conv_out)                                 # (B,Cd)
    xin = xbc1[:, :d_inner].reshape(B, nheads, P)
    Bm = xbc1[:, d_inner:d_inner + N]                       # (B,N)
    Cm = xbc1[:, d_inner + N:]                              # (B,N)
    dtv = _softplus(dt[:, 0].float() + p["dt_bias"].float())  # (B,nh)
    A = -torch.exp(p["A_log"].float())                      # (nh,)
    dA = torch.exp(dtv * A[None, :])                        # (B,nh)
    dBx = ((dtv[..., None] * xin.float())[..., None]
           * Bm.float()[:, None, None, :])                  # (B,nh,P,N)
    new_state = cache["ssm"] * dA[..., None, None] + dBx
    y = (new_state @ Cm.float()[:, None, :, None])[..., 0]  # (B,nh,P)
    y = y.to(h.dtype) + xin * p["D"].to(h.dtype)[None, :, None]
    y = y.reshape(B, 1, d_inner) * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = y @ p["out_proj"].to(h.dtype)
    return out, {"ssm": new_state, "conv": new_conv}


def mamba2_residual_decode(lp, h, cfg, caches, i: int):
    """Layer ``i`` of a Mamba2 stack at one token: h + block(rmsnorm(h)),
    the layer's state read from ``caches["ssm"][i]`` / ``caches["conv"][i]``
    and written back there IN PLACE (the JAX function returns new stacked
    caches; the engine keeps one)."""
    y, new = mamba2_decode(lp["block"], rmsnorm(lp["ln"], h, cfg.norm_eps),
                           cfg, {"ssm": caches["ssm"][i],
                                 "conv": caches["conv"][i]})
    caches["ssm"][i] = new["ssm"]
    caches["conv"][i] = new["conv"]
    return h + y
