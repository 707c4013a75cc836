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

Sharded (DTensors inside a ``shard_ctx``): both projections go through
``layers._proj``, and the block between them runs per shard under
``local_map`` on each rank's batch rows and heads, B and C whole
(``_ssd_sharded``, ``_decode_sharded``): the causal conv, the chunk scan
and the state update are plain torch there.  The same functions
(``_ssd_heads``, ``_decode_heads``) run every head on one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain, is_dtensor, shard_axis

from repro_torch.models.layers import _proj, decls_rmsnorm, rmsnorm
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


def _head_columns(cfg, h0: int, nhl: int, device):
    """The ``in_proj`` columns of heads h0..h0+nhl-1 ([z, x] of those
    heads, all of B and C, their dt) and the conv channels they read (x of
    those heads, B, C), as index tensors."""
    d_inner, _, N, _ = ssm_dims(cfg)
    P = cfg.ssm_head_dim
    xs = torch.arange(h0 * P, (h0 + nhl) * P, device=device)
    bc = torch.arange(d_inner, d_inner + 2 * N, device=device)
    dts = torch.arange(h0, h0 + nhl, device=device) + 2 * (d_inner + N)
    return torch.cat([xs, xs + d_inner, bc + d_inner, dts]), \
        torch.cat([xs, bc])


def _ssd_heads(zxbcdt, cw, cb, a_log, dvec, dt_bias, cfg):
    """The block between its two projections on nhl heads (all of them on
    one card; a rank's own under ``local_map``): zxbcdt (B,S,2·nhl·P + 2N
    + nhl), the ``in_proj`` output's columns of those heads (z, x, then B
    and C, then dt), ``cw``/``cb`` the conv channels they read, ``a_log``,
    ``dvec``, ``dt_bias`` (nhl,).  Returns (y (B,S,nhl·P) gated, before
    the norm; the final state (B,nhl,P,N) f32; the conv input's last K-1
    positions (B,K-1,nhl·P + 2N): those heads' x, then B and C)."""
    N = cfg.ssm_state
    P = cfg.ssm_head_dim
    B, S, _ = zxbcdt.shape
    nhl = a_log.shape[0]
    dl = nhl * P
    z, xbc, dt = (zxbcdt[..., :dl], zxbcdt[..., dl:2 * dl + 2 * N],
                  zxbcdt[..., -nhl:])
    tail = xbc[:, -(cfg.ssm_conv_width - 1):, :]
    xbc = _causal_conv(xbc, cw, cb)
    xin = xbc[..., :dl].reshape(B, S, nhl, P)
    Bm = xbc[..., dl:dl + N]
    Cm = xbc[..., dl + N:]
    dt = _softplus(dt.float() + dt_bias.float())
    A = -torch.exp(a_log.float())
    y, fstate = ssd_chunked(xin, dt, A, Bm, Cm, min(cfg.ssm_chunk, S))
    y = y + xin * dvec.to(y.dtype)[None, None, :, None]
    return y.reshape(B, S, dl) * F.silu(z), fstate, tail


def _head_split(p, cfg, mesh):
    """(the mesh dim that shards the heads, or None; the local head count;
    the first local head) of the block ``p``'s DTensors: the heads are
    ``A_log``'s dim."""
    nheads = ssm_dims(cfg)[1]
    hx = shard_axis(p["A_log"], 0)
    if hx is None:
        return None, nheads, 0
    nhl = nheads // mesh.size(hx)
    return hx, nhl, mesh.get_local_rank(hx) * nhl


def _ssd_sharded(p, h, cfg, state: bool):
    """``_ssd_heads`` of DTensors, per shard (``local_map``): each rank
    runs its own batch rows and heads (JAX's ``constrain(xin, "dp", None,
    "tp", None)``), B and C whole on every rank, so the conv and the chunk
    scan run on plain tensors and issue no collective; the gradients of
    h, of B and C and of the weights are partial sums over the head axis.

    The ``in_proj`` output's dim is sharded on ``tp`` without regard to
    the [z, x, B, C, dt] boundaries, so a rank's head columns are not its
    shard: the weight is gathered over the head axis once (its gradient
    reduce-scattered) and each rank multiplies by its heads' columns.
    Returns y (heads sharded), and where ``state`` the final state
    (heads sharded) and the conv tail (x of every head, then B and C: its
    x gathered over the head axis)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = h.device_mesh
    hx, nhl, h0 = _head_split(p, cfg, mesh)
    rows = [pl.is_shard(0) for pl in h.placements]

    def per_dim(batch, heads, other=Replicate()):
        return tuple(batch if rows[j] else heads if j == hx else other
                     for j in range(mesh.ndim))
    R, P0 = Replicate(), Partial()
    act_in, act_grad = per_dim(Shard(0), R), per_dim(Shard(0), P0)
    w_in, w_grad = per_dim(R, R), per_dim(P0, P0)
    head_in, head_grad = per_dim(R, Shard(0)), per_dim(P0, Shard(0))
    y_out, s_out = per_dim(Shard(0), Shard(2)), per_dim(Shard(0), Shard(1))
    bc_out = per_dim(Shard(0), R)
    dt = h.dtype
    some_heads = nhl != ssm_dims(cfg)[1]

    def local(hl, wl, cw, cb, a_log, dvec, dt_bias):
        if some_heads:
            cols, conv = _head_columns(cfg, h0, nhl, cw.device)
            wl = wl.index_select(1, cols)
            cw, cb = cw.index_select(1, conv), cb.index_select(0, conv)
        zx = _proj(hl, wl)
        y, fstate, tail = _ssd_heads(zx, cw, cb, a_log, dvec, dt_bias, cfg)
        if not state:
            return y
        dl = y.shape[-1]
        return y, fstate, tail[..., :dl].contiguous(), \
            tail[..., dl:].contiguous()
    out = local_map(
        local,
        out_placements=(list(y_out) if not state
                        else (y_out, s_out, y_out, bc_out)),
        in_placements=(act_in, w_in, w_in, w_in, head_in, head_in, head_in),
        in_grad_placements=(act_grad, w_grad, w_grad, w_grad, head_grad,
                            head_grad, head_grad),
        device_mesh=mesh, redistribute_inputs=True)(
            h, p["in_proj"].to(dt), p["conv_w"].to(dt), p["conv_b"].to(dt),
            p["A_log"], p["D"], p["dt_bias"])
    if not state:
        return out, None, None
    y, fstate, tail_x, tail_bc = out
    tail_x = tail_x.redistribute(mesh, bc_out)
    return y, fstate, torch.cat([tail_x, tail_bc], dim=-1)


def mamba2_prefill(p, h, cfg, state: bool = True):
    """Full-sequence forward of one block: h (B,S,D) → (y (B,S,D), the
    final SSM state (B,nh,P,N) f32, the conv tail (B,K-1,Cd): the inputs
    of the last K-1 positions, before the conv).  ``state=False`` returns
    (y, None, None): a DTensor step then gathers no tail."""
    if is_dtensor(h):
        y, fstate, conv_tail = _ssd_sharded(p, h, cfg, state)
    else:
        y, fstate, conv_tail = _ssd_heads(
            _proj(h, p["in_proj"].to(h.dtype)), p["conv_w"].to(h.dtype),
            p["conv_b"].to(h.dtype), p["A_log"], p["D"], p["dt_bias"], cfg)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return _proj(y, p["out_proj"].to(h.dtype)), fstate, conv_tail


def mamba2_block(p, h, cfg):
    """Full-sequence forward: h (B,S,D) → (B,S,D)."""
    return mamba2_prefill(p, h, cfg, state=False)[0]


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


def _decode_heads(zxbcdt, conv, ssm, cw, cb, a_log, dvec, dt_bias, cfg,
                  h0: int, nhl: int):
    """One token of the block between its projections on heads
    h0..h0+nhl-1: zxbcdt (B,1,E) and the conv cache (B,K-1,Cd) whole, the
    state ``ssm`` (B,nhl,P,N) of those heads.  Returns (y (B,1,nhl·P)
    gated, before the norm; the new state; the new conv cache, whole)."""
    d_inner, _, N, _ = ssm_dims(cfg)
    B = zxbcdt.shape[0]
    P = cfg.ssm_head_dim
    c0, c1 = h0 * P, (h0 + nhl) * P
    z, xbc, dt = _split_proj(cfg, zxbcdt)                   # xbc (B,1,Cd)
    # rolling conv buffer
    window = torch.cat([conv, xbc], dim=1)                  # (B,K,Cd)
    new_conv = window[:, 1:, :]
    conv_out = (window * cw).sum(1) + cb
    xbc1 = F.silu(conv_out)                                 # (B,Cd)
    xin = xbc1[:, c0:c1].reshape(B, nhl, P)
    Bm = xbc1[:, d_inner:d_inner + N]                       # (B,N)
    Cm = xbc1[:, d_inner + N:]                              # (B,N)
    dtv = _softplus(dt[:, 0, h0:h0 + nhl].float() + dt_bias.float())
    A = -torch.exp(a_log.float())                           # (nhl,)
    dA = torch.exp(dtv * A[None, :])                        # (B,nhl)
    dBx = ((dtv[..., None] * xin.float())[..., None]
           * Bm.float()[:, None, None, :])                  # (B,nhl,P,N)
    new_state = ssm * dA[..., None, None] + dBx
    y = (new_state @ Cm.float()[:, None, :, None])[..., 0]  # (B,nhl,P)
    y = y.to(zxbcdt.dtype) + xin * dvec.to(zxbcdt.dtype)[None, :, None]
    return y.reshape(B, 1, nhl * P) * F.silu(z[..., c0:c1]), new_state, \
        new_conv


def _decode_sharded(p, zxbcdt, cfg, cache):
    """``_decode_heads`` of DTensors, per shard (``local_map``): the
    projection's output and the conv cache gathered whole on each rank's
    batch rows (one token's and K-1 tokens' worth), the state and the
    output on its own heads; the new conv cache comes back whole on the
    head axis (the caller's placement keeps a rank's part of it)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = zxbcdt.device_mesh
    hx, nhl, h0 = _head_split(p, cfg, mesh)
    rows = [pl.is_shard(0) for pl in zxbcdt.placements]

    def per_dim(batch, heads):
        return tuple(batch if rows[j] else heads if j == hx else Replicate()
                     for j in range(mesh.ndim))
    R = Replicate()
    whole, heads = per_dim(Shard(0), R), per_dim(R, Shard(0))
    state, y_out = per_dim(Shard(0), Shard(1)), per_dim(Shard(0), Shard(2))
    dt = zxbcdt.dtype
    return local_map(
        lambda *a: _decode_heads(*a, cfg, h0, nhl),
        out_placements=(y_out, state, whole),
        in_placements=(whole, whole, state, per_dim(R, R), per_dim(R, R),
                       heads, heads, heads),
        device_mesh=mesh, redistribute_inputs=True)(
            zxbcdt, cache["conv"], cache["ssm"], p["conv_w"].to(dt),
            p["conv_b"].to(dt), p["A_log"], p["D"], p["dt_bias"])


def mamba2_decode(p, h, cfg, cache):
    """h (B,1,D); cache {"ssm": (B,nh,P,N) f32, "conv": (B,K-1,Cd)}.
    Returns (y (B,1,D), the new cache); ``cache`` is not written."""
    nheads = ssm_dims(cfg)[1]
    zxbcdt = _proj(h, p["in_proj"].to(h.dtype))
    if is_dtensor(zxbcdt):
        y, new_state, new_conv = _decode_sharded(p, zxbcdt, cfg, cache)
    else:
        y, new_state, new_conv = _decode_heads(
            zxbcdt, cache["conv"], cache["ssm"], p["conv_w"].to(h.dtype),
            p["conv_b"].to(h.dtype), p["A_log"], p["D"], p["dt_bias"], cfg,
            0, nheads)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = _proj(y, p["out_proj"].to(h.dtype))
    return out, {"ssm": new_state, "conv": new_conv}


def _set_layer(stack, i: int, new):
    """``stack[i] = new`` in place; a DTensor stack (a leading layer dim
    that no mesh axis shards) written on each rank's own shard, ``new``
    placed as the layer's slice of it first."""
    if not is_dtensor(stack):
        stack[i] = new
        return
    from torch.distributed.tensor import Shard
    want = tuple(Shard(pl.dim - 1) if pl.is_shard() else pl
                 for pl in stack.placements)
    stack.to_local()[i] = new.redistribute(stack.device_mesh,
                                           want).to_local()


def mamba2_residual_decode(lp, h, cfg, caches, i: int):
    """Layer ``i`` of a Mamba2 stack at one token: h + block(rmsnorm(h)),
    the layer's state read from ``caches["ssm"][i]`` / ``caches["conv"][i]``
    and written back there IN PLACE (the JAX function returns new stacked
    caches; the engine keeps one)."""
    y, new = mamba2_decode(lp["block"], rmsnorm(lp["ln"], h, cfg.norm_eps),
                           cfg, {"ssm": caches["ssm"][i],
                                 "conv": caches["conv"][i]})
    _set_layer(caches["ssm"], i, new["ssm"])
    _set_layer(caches["conv"], i, new["conv"])
    return h + y
