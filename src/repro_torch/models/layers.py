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
``jax.checkpoint``).

Sharding: ``constrain`` states JAX's activation layouts at JAX's sites (q
by batch and heads, the decode caches); it acts on DTensors inside a
``shard_ctx`` with a ``DeviceMesh`` (the sharded step,
``distributed/sharding.py``) and is an identity on one card.  Two ops run
per shard under ``local_map`` when their operands are DTensors: the
embedding lookup (a vocab-sharded table looks up its own rows and the
lookup is a partial sum over the vocab axis, Megatron's vocab-parallel
embedding) and the gold logit of the loss (each vocab shard reads the
targets that fall in it); the loss's log-sum-exp over a vocab-sharded
dim is a max and a sum that DTensor reduces over the shards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (constrain, is_dtensor,
                                              shard_axis)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.params import decl

NEG_INF = -1e30


def _proj(x, w):
    """x (..., D) against w (D, *out) → (..., *out): JAX's
    ``einsum("...d,d...->...")`` as one contiguous matrix product."""
    if is_dtensor(x) or is_dtensor(w):
        return _proj_sharded(x, w)
    return (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def _proj_sharded(x, w):
    """``_proj`` of DTensors, each rank's product on its own shards
    (``local_map``), mesh dim by mesh dim:

      * x sharded on a leading dim (the batch on a ``dp`` axis): w gathered
        there (FSDP; its gradient a partial sum, reduce-scattered back);
      * x sharded on D and w on D (the row-parallel product after a
        head- or ``tp``-sharded layer): the product a partial sum, reduced
        at once in its own dtype (Megatron's row-parallel all-reduce; left
        partial, DTensor's choice of where to reduce it differs between
        PyTorch versions, and one reduced it in f32 inside the next norm
        and once more for each product that read the norm);
      * x replicated and w sharded on an output dim (column-parallel, the
        q/k/v, MLP-up and vocab products): the output sharded on that dim,
        x's gradient a partial sum; w sharded on D there: gathered.

    The output comes out in w's layout (..., *out) on each rank, so a
    head dim is never unflattened out of a sharded one."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = (w if is_dtensor(w) else x).device_mesh
    rep = (Replicate(),) * mesh.ndim
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    if not is_dtensor(w):
        w = DTensor.from_local(w, mesh, rep, run_check=False)
    last = x.dim() - 1
    x_in, w_in, out, x_grad, w_grad = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if xp.is_shard() and xp.dim < last:
            x_in.append(xp)
            w_in.append(Replicate())
            out.append(xp)
            x_grad.append(xp)
            w_grad.append(Partial())
        elif xp.is_shard(last):
            x_in.append(xp)
            w_in.append(Shard(0))
            out.append(Partial())
            x_grad.append(xp)
            w_grad.append(Shard(0))
        elif wp.is_shard() and wp.dim >= 1:
            x_in.append(Replicate())
            w_in.append(wp)
            out.append(Shard(last + wp.dim - 1))
            x_grad.append(Partial())
            w_grad.append(wp)
        else:
            x_in.append(Replicate())
            w_in.append(Replicate())
            out.append(Replicate())
            x_grad.append(Replicate())
            w_grad.append(Replicate())

    def mm(xl, wl):
        return (xl @ wl.reshape(wl.shape[0], -1)).view(*xl.shape[:-1],
                                                       *wl.shape[1:])
    y = local_map(mm, out_placements=out,
                  in_placements=(tuple(x_in), tuple(w_in)),
                  in_grad_placements=(tuple(x_grad), tuple(w_grad)),
                  device_mesh=mesh, redistribute_inputs=True)(x, w)
    if any(p.is_partial() for p in out):
        y = y.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in out])
    return y


# ---------------------------------------------------------------------------
# Norms and rotary position embeddings
# ---------------------------------------------------------------------------

def decls_rmsnorm(d):
    return {"scale": decl((d,), (None,), init="ones")}


def rmsnorm(p, x, eps=1e-6):
    if is_dtensor(x) and shard_axis(x, x.dim() - 1) is not None:
        return _rmsnorm_sharded(p, x, eps)
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(dt)


def _rmsnorm_sharded(p, x, eps):
    """``rmsnorm`` of a DTensor sharded on its last dim (the SSM block's
    gated norm over its heads), per shard: each rank's sum of squares over
    its own columns, those sums (B, S, 1) f32 all-reduced, and its own
    columns scaled; the columns are never gathered (left to DTensor, the
    backward gathered them in f32)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, n = x.device_mesh, x.shape[-1]
    ax = shard_axis(x, x.dim() - 1)
    xp = tuple(x.placements)
    ss_part = tuple(Partial() if j == ax else pl for j, pl in enumerate(xp))
    ss_whole = tuple(Replicate() if j == ax else pl
                     for j, pl in enumerate(xp))
    s_in = tuple(Shard(0) if j == ax else Replicate()
                 for j in range(mesh.ndim))
    s_grad = tuple(Shard(0) if j == ax else
                   Partial() if pl.is_shard() else Replicate()
                   for j, pl in enumerate(xp))
    ss = local_map(lambda xl: xl.float().square().sum(-1, keepdim=True),
                   out_placements=list(ss_part), in_placements=(xp,),
                   device_mesh=mesh, redistribute_inputs=True)(x)
    ss = _reduced(ss, ax)

    def scaled(xl, ssl, sl):
        y = xl.float() * torch.rsqrt(ssl / n + eps)
        return (y * sl.float()).to(xl.dtype)
    return local_map(scaled, out_placements=list(xp),
                     in_placements=(xp, ss_whole, s_in),
                     in_grad_placements=(xp, ss_part, s_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
                         x, ss, p["scale"])


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
    q = constrain(q, "dp", None, "qheads", None)
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
    if is_dtensor(cache_k):
        _write_sharded(cache_k, k[:, 0], posb)
        _write_sharded(cache_v, v[:, 0], posb)
    else:
        _write_at(cache_k, k[:, 0], posb, 0, T)
        _write_at(cache_v, v[:, 0], posb, 0, T)
    cache_k = constrain(cache_k, "dp", "kvseq", "kvheads", None)
    cache_v = constrain(cache_v, "dp", "kvseq", "kvheads", None)
    mask = torch.arange(T, device=x.device)[None, :] <= posb[:, None]   # (B,T)
    kr = constrain(_repeat_kv(cache_k, H), "dp", "dkr_t", "dkr_h", None)
    vr = constrain(_repeat_kv(cache_v, H), "dp", "dkr_t", "dkr_h", None)
    out = _attend(q, kr, vr, cfg, mask[:, None, None, :])
    y = _proj(out.flatten(2), p["wo"].to(x.dtype).flatten(0, 1))
    return y, cache_k, cache_v


def _write_at(cache, new, posb, t0: int, T: int):
    """cache (B, Tl, H, Dh) holding positions t0..t0+Tl-1 of T: row b's
    ``new`` (B, H, Dh) written in place at ``posb[b]`` where it falls in
    them (and below T).  No host sync: a dropped row rewrites its own
    value."""
    Tl = cache.shape[1]
    rel = posb - t0
    keep = ((rel >= 0) & (rel < Tl) & (posb < T))[:, None, None]
    bidx = torch.arange(cache.shape[0], device=cache.device)
    at = rel.clamp(0, Tl - 1)
    cache[bidx, at] = torch.where(keep, new, cache[bidx, at])


def _write_sharded(cache, new, posb):
    """``_write_at`` of a DTensor cache, per shard: each rank writes its
    own batch rows, kv heads and, where the cache is sequence-sharded, the
    positions it holds."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, T = cache.device_mesh, cache.shape[1]
    new_pl, pos_pl = [], []
    for pl in cache.placements:
        new_pl.append(Shard(0) if pl.is_shard(0) else
                      Shard(1) if pl.is_shard(2) else Replicate())
        pos_pl.append(Shard(0) if pl.is_shard(0) else Replicate())
    seq = shard_axis(cache, 1)
    t0 = 0 if seq is None else mesh.get_local_rank(seq) * (T // mesh.size(seq))

    def write(c, n, pb):
        _write_at(c, n, pb, t0, T)
        return c
    cp = tuple(cache.placements)
    local_map(write, out_placements=list(cp),
              in_placements=(cp, tuple(new_pl), tuple(pos_pl)),
              device_mesh=mesh, redistribute_inputs=True)(cache, new, posb)


def prefill_caches(decls, cfg, like):
    """The caches a prefill fills, allocated once before its layer loop
    (JAX's scan writes its stacked output in place): ``decls``' shapes
    and dtypes (a dict of ``ParamDecl``, the model's ``cache_decls``),
    empty, on the device of ``like`` (the hidden state).  Where ``like``
    is a DTensor, DTensors on its mesh placed by the declarations' specs,
    each rank allocating only its shard.  ``write_layer`` fills them."""
    from repro_torch.distributed.sharding import physical_specs, placements
    if not is_dtensor(like):
        return {k: torch.empty(d.shape, dtype=d.dtype, device=like.device)
                for k, d in decls.items()}
    from torch.distributed.tensor import DTensor
    mesh = like.device_mesh
    out = {}
    for (k, d), spec in zip(decls.items(),
                            physical_specs(decls, cfg, mesh).values()):
        pl = placements(spec, mesh)
        local = list(d.shape)
        for j, p in enumerate(pl):
            if p.is_shard():          # the specs divide every sharded dim
                local[p.dim] //= mesh.size(j)
        out[k] = DTensor.from_local(
            torch.empty(local, dtype=d.dtype, device=like.device), mesh, pl,
            run_check=False)
    return out


def write_layer(cache, i, t):
    """Slot ``i`` of a ``prefill_caches`` cache set to one layer's ``t``,
    in place.  A DTensor cache is written per shard, as decode's
    ``_write_sharded`` writes: ``t`` placed as the slot (a dim ``t``
    holds whole and the cache shards is cut locally, no collective), then
    each rank's local shard copied into its local cache.  Returns what
    the rest of the layer reads in place of ``t``: the slot where it lies
    as ``t`` does (so ``t`` itself can be freed), else ``t``."""
    if not is_dtensor(cache):
        cache[i].copy_(t)
        return cache[i]
    from torch.distributed.tensor import Shard
    want = tuple(Shard(p.dim - 1) if p.is_shard() else p
                 for p in cache.placements)
    if tuple(t.placements) == want:
        cache.to_local()[i].copy_(t.to_local())
        return cache[i]
    cache.to_local()[i].copy_(t.redistribute(cache.device_mesh,
                                             want).to_local())
    return t


def _attend(q, k, v, cfg, mask=None):
    """Plain attention, q (B,Sq,H,Dh) against k/v (B,Skv,H,Dh): scores in
    q's dtype, scaled, then softmax in f32 (masked where ``mask``, which
    broadcasts to (B,H,Sq,Skv), is False)."""
    if is_dtensor(q):
        return _attend_sharded(q, k, v, cfg, mask)
    scores = torch.einsum("bqhe,bshe->bhqs", q, k) * (cfg.head_dim ** -0.5)
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshe->bqhe", probs, v)


def _attend_sharded(q, k, v, cfg, mask=None):
    """``_attend`` of DTensors, per shard (``local_map``): each rank's
    batch rows and heads; where k/v are sharded on time (the decode
    cache's ``dkr_t``), the softmax is combined over that axis, its max
    and sum all-reduced (the flash-decode combine), and the rank's partial
    output summed.  ``mask`` is (B, 1, 1, Skv) or None."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    rep = (Replicate(),) * mesh.ndim
    k, v, mask = (t if t is None or is_dtensor(t) else
                  DTensor.from_local(t, mesh, rep, run_check=False)
                  for t in (k, v, mask))
    q_pl, kv_pl, m_pl = [], [], []
    t_axis = None
    for j, (qp, kp) in enumerate(zip(q.placements, k.placements)):
        if qp.is_shard(0) and kp.is_shard(0):
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
            m_pl.append(Shard(0))
        elif kp.is_shard(1) and t_axis is None:
            t_axis = j
            q_pl.append(Replicate())
            kv_pl.append(Shard(1))
            m_pl.append(Shard(3))
        elif qp.is_shard(2) or kp.is_shard(2):
            q_pl.append(Shard(2))
            kv_pl.append(Shard(2))
            m_pl.append(Replicate())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            m_pl.append(Replicate())
    scale = cfg.head_dim ** -0.5

    def attend(ql, kl, vl, ml):
        scores = (torch.einsum("bqhe,bshe->bhqs", ql, kl) * scale).float()
        if ml is not None:
            scores = torch.where(ml, scores,
                                 torch.full((), NEG_INF, device=ql.device))
        if t_axis is None:
            probs = torch.softmax(scores, dim=-1).to(ql.dtype)
            return torch.einsum("bhqs,bshe->bqhe", probs, vl)
        group = (mesh, t_axis)
        m = funcol.all_reduce(scores.detach().amax(-1, keepdim=True), "max",
                              group)
        e = torch.exp(scores - m)
        s = funcol.all_reduce(e.sum(-1, keepdim=True), "sum", group)
        o = torch.einsum("bhqs,bshe->bqhe", (e / s).to(ql.dtype), vl)
        return funcol.all_reduce(o, "sum", group)
    q_pl, kv_pl = tuple(q_pl), tuple(kv_pl)
    m_in = None if mask is None else tuple(m_pl)
    return local_map(attend, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl, m_in),
                     device_mesh=mesh, redistribute_inputs=True)(
                         q, k, v, mask)


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
        g = _proj(x, p["w_gate"].to(x.dtype))
        u = _proj(x, p["w_up"].to(x.dtype))
        h = F.silu(g) * u
    else:
        h = _proj(x, p["w_up"].to(x.dtype))
        # jax.nn.gelu's default is the tanh form
        h = (F.gelu(h, approximate="tanh") if cfg.mlp_type == "gelu"
             else F.relu(h).square())
    return _proj(h, p["w_down"].to(x.dtype))


def decls_embedding(cfg):
    V, D = cfg.vocab_size, cfg.d_model
    d = {"tok": decl((V, D), ("vocab", "fsdp"), scale=1.0, init="normal")}
    if not cfg.tie_embeddings:
        d["out"] = decl((D, V), ("fsdp", "vocab"))
    return d


def embed(p, tokens, cfg, compute_dtype):
    table = p["tok"].to(compute_dtype)
    if is_dtensor(table):
        return _embed_sharded(table, tokens)
    return table[tokens]


def _embed_sharded(table, tokens):
    """The lookup of a DTensor ``table`` (V, D) per shard: the table
    gathered on every mesh axis but a vocab one, each rank looking up its
    own tokens; where the vocab is sharded, each shard's rows (the rest
    zero), a partial sum over that axis.  The table's gradient is a
    partial sum over the axes that shard the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tok_pl = (tokens.placements if is_dtensor(tokens)
              else (Replicate(),) * mesh.ndim)
    vocab = shard_axis(table, 0)
    if vocab is not None and tok_pl[vocab] != Replicate():
        vocab = None                    # the tokens hold that axis
    t_in, out, grad = [], [], []
    for j, tp in enumerate(tok_pl):
        if j == vocab:
            t_in.append(Shard(0))
            out.append(Partial())
            grad.append(Shard(0))
        else:
            t_in.append(Replicate())
            out.append(tp)
            grad.append(Partial() if tp.is_shard() else Replicate())
    lo = 0 if vocab is None else (mesh.get_local_rank(vocab)
                                  * (table.shape[0] // mesh.size(vocab)))

    def lookup(tab, tok):
        if vocab is None:
            return tab[tok]
        idx = tok.long() - lo
        ok = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[idx.clamp(0, tab.shape[0] - 1)]
        return torch.where(ok[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
    from torch.distributed.tensor.experimental import local_map
    return local_map(lookup, out_placements=list(out),
                     in_placements=(tuple(t_in), tuple(tok_pl)),
                     in_grad_placements=(tuple(grad), tuple(tok_pl)),
                     device_mesh=mesh, redistribute_inputs=True)(
                         table, tokens)


def table_prefix(table, n: int):
    """``table[:n]``: a learned position table's first n rows.  Of a
    DTensor (its rows never sharded), the rows pass a ``local_map`` that
    keeps their placements, so their gradient is made to those
    placements on the (n, D) rows where it is made (over a data axis
    that shards D, reduce-scattered as FSDP does), and never reduced on
    the whole table (left to DTensor, torch 2.13 all-reduced whisper's
    (32768, 1024) ``pos_dec`` gradient a step, 2.11 only its rows)."""
    rows = table[:n]
    if not is_dtensor(rows):
        return rows
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(rows.placements)
    return local_map(lambda t: t, out_placements=list(pl),
                     in_placements=(pl,), in_grad_placements=(pl,),
                     device_mesh=rows.device_mesh,
                     redistribute_inputs=True)(rows)


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
    if not is_dtensor(logits):
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    elif shard_axis(logits, logits.dim() - 1) is not None:
        return _nll_vocab_sharded(logits, targets)
    else:
        gold = _gold_per_rank(logits, targets)
    return torch.logsumexp(logits, dim=-1) - gold


def _as_dtensor(targets, mesh):
    """Targets as a DTensor over ``mesh`` (a plain tensor is each rank's
    whole, replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    return (targets if is_dtensor(targets)
            else DTensor.from_local(
                targets, mesh, (Replicate(),) * mesh.ndim, run_check=False))


def _gold_per_rank(logits, targets):
    """The gold logit of DTensor logits whole on the vocab, read by each
    rank from its own block under ``local_map``, the targets placed as the
    logits' rows: the backward scatters into zeros of the rank's block.
    (Left to DTensor, ``GatherBackward0`` made zeros of the global logits'
    sizes on every rank: (B, S, V) f32 of the whole batch.)"""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = logits.device_mesh, tuple(logits.placements)
    tgt_pl = tuple(Replicate() if p.is_partial() else p for p in pl)

    def gold(lg, tg):
        return torch.gather(lg, -1, tg[..., None].long())[..., 0]
    return local_map(gold, out_placements=list(pl),
                     in_placements=(pl, tgt_pl), device_mesh=mesh,
                     redistribute_inputs=True)(
                         logits, _as_dtensor(targets, mesh))


def _nll_vocab_sharded(logits, targets):
    """``_nll`` of DTensor logits sharded on the vocab: the log-sum-exp as
    a max and a sum of exponentials that DTensor reduces over the vocab
    shards, the gold logit read per shard (the targets in its range, the
    rest zero) and summed over them."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, last = logits.device_mesh, logits.dim() - 1
    vocab = shard_axis(logits, last)
    lo = mesh.get_local_rank(vocab) * (logits.shape[-1] // mesh.size(vocab))
    tgt = _as_dtensor(targets, mesh)
    tgt_pl = tuple(p if j != vocab else Replicate()
                   for j, p in enumerate(logits.placements))
    gold_pl = tuple(Partial() if j == vocab else p
                    for j, p in enumerate(logits.placements))

    def gold(lg, tg):
        idx = tg.long() - lo
        ok = (idx >= 0) & (idx < lg.shape[-1])
        g = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(ok, g[..., 0],
                           torch.zeros((), dtype=lg.dtype, device=lg.device))
    g = local_map(gold, out_placements=list(gold_pl),
                  in_placements=(tuple(logits.placements), tgt_pl),
                  device_mesh=mesh, redistribute_inputs=True)(logits, tgt)
    # each reduction over the vocab shards made whole on every rank before
    # it is used: the rows stay batch-sharded as the targets are, and no
    # logit is ever gathered
    m = _reduced(logits.detach().amax(dim=-1, keepdim=True), vocab)
    s = _reduced(torch.sum(torch.exp(logits - m), dim=-1), vocab)
    return torch.log(s) + m[..., 0] - _reduced(g, vocab)


def _reduced(x, axis: int):
    """A DTensor's partial result over mesh dim ``axis`` reduced there
    (made replicated on it)."""
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if j == axis else pl
                 for j, pl in enumerate(x.placements))
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def softmax_xent(logits, targets, mask=None):
    """logits (..., V); targets (...) int; the mean negative log-likelihood
    over valid tokens, in f32."""
    nll = _nll(logits, targets)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _chunk_nll(hc, W, tc, mc):
    """One chunk's (sum of nll, token count) in f32."""
    nll = _nll(_proj(hc, W), tc)
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
        return softmax_xent(_proj(h, W), targets, mask)
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
