"""``flash_attention``: the self-attention of the LM block prefill.

Replaces the TPU kernel
``src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas`` with
the hand-written CUDA kernels of ``kernels/csrc/flash_attention.cu``.

Contract: the JAX wrapper's (``src/repro/kernels/flash_attention/ops.py``)
``(B, S, H, Dh)`` layout and ``Dh ** -0.5`` scale, widened to what the
model's ``_repeat_kv`` + ``_attend`` compute:
  * any S ≥ 1 (the ragged last tile is masked; the JAX wrapper asserts
    ``S % block == 0``);
  * k/v may carry Hkv heads with ``H % Hkv == 0``: head h reads kv head
    ``h // (H // Hkv)``, with no repeated copy;
  * float32 or bfloat16 (q, k and v of one type); the output has q's type.
On the card Dh is one of ``HEAD_DIMS`` and the inputs are contiguous.
Dh = 8 runs the kernels' 16-wide instance and Dh = 112 their 128-wide
one, over the tensors as they are: the tensor maps carry the real width,
TMA fills the missing columns of each tile with zeros and the stores stop
at Dh (a Dh = 112 call does 128/112 of the arithmetic).  A CUDA tensor of
another width raises; nothing pads it here.

Bound: operations (``4·B·H·Dh·S(S+1)/2`` FLOP causal) at the prefill's
shapes.  bf16 runs the Hopper kernel (TMA ring, ``wgmma``, warp-specialised
consumers) at every Dh, f32 the SIMT kernel; see the note in the CUDA
source for both designs.

Gradient (training): when grad is enabled and an input requires it, the
call goes through ``FlashAttention``, a ``torch.autograd.Function``.  Its
forward launches the same kernel with a pointer for each row's log-sum-exp
(``(B, H, S)`` f32, natural log; ``O`` is bit-equal to the call without
it) and saves ``q, k, v, o, lse``; its backward is
``flash_attention_bwd``: the hand-written kernels of
``kernels/csrc/flash_attention_bwd.cu`` (bf16 the Hopper kernels, f32 the
SIMT ones; deterministic, no float atomics; the TPU kernel has no
backward: JAX differentiates its jnp attention).

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the kernel or raises.  A tensor on the ``meta`` device (the
dry-run's trace, launch/dryrun.py) carries no data: ``flash_attention``
returns the plain version's forward under ordinary autograd there, so a
traced step counts the work of the JAX model's jnp attention and its
autodiff, which is what XLA counts; ``_forward`` and
``flash_attention_bwd`` refuse it, as every other device.

The memory trace (``launch/dryrun.py``, ``launch/footprint.LiveBytes``)
needs the kernels' footprint instead: within ``footprint()``,
``flash_attention`` on any device computes nothing and allocates what the
card does, ``FlashAttentionFootprint`` (the forward's ``o`` and ``lse``,
saved with ``q, k, v``; the backward's ``do.contiguous()``, ``dq, dk,
dv`` and the ``(B, H, S)`` f32 ``d_rows``), or the forward's ``o`` alone
without a gradient.  The plain version would keep the (B, H, S, S)
probabilities for its backward, which the card never allocates.
``flash_attention.launches`` counts forward kernel launches,
``flash_attention_bwd.launches`` backward ones (one a call: the C entry
launches its two kernels), and nothing else.

Sharded (the sharded LM step): DTensor ``q, k, v`` run per shard under
``local_map``, each rank's call on its own batch rows and heads, so the
attention moves no data (Megatron's head-parallel attention): q keeps its
placements (batch on the ``dp`` axes, heads on the ``model`` axis where
they divide it, else replicated); k and v follow q's batch placements and
are sharded on heads alongside q's where the kv heads divide that axis.
Where they do not (``tp_kv`` resolves to replicated), each rank holds
every kv head and takes the ones its q heads read: a slice where its q
heads cover whole GQA groups or lie in one, else one kv head per q head;
their gradient is then a partial sum over that axis.  On the card each
rank's call launches the kernels at its own head counts (e.g. 12 q and 4
kv heads of llama3.2-3b's 24 and 8 on a 2-wide axis).
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

_DTYPES = (torch.float32, torch.bfloat16)
# the head widths the card takes, each with the kernels' template width it
# runs on (the narrowest of 16, 32, 64 and 128 that holds it); the CUDA
# source is told the template at every launch
TEMPLATE_WIDTH = {8: 16, 16: 16, 32: 32, 64: 64, 112: 128, 128: 128}
HEAD_DIMS = tuple(TEMPLATE_WIDTH)
ENCODE_ERROR = 100000      # the C function's code: this + a CUresult
_fns = {}
_FOOTPRINT = {"on": False}


def _kernel(name: str = "flash_attention"):
    """The C entry of ``csrc/<name>.cu``: ``flash_attention_launch`` (q, k,
    v, o, lse pointers) or ``flash_attention_bwd_launch`` (q, k, v, o, lse,
    do, dq, dk, dv and the D scratch)."""
    fn = _fns.get(name)
    if fn is None:
        from repro_torch.kernels.build import load
        fn = getattr(load(name), f"{name}_launch")
        n_ptr = 5 if name == "flash_attention" else 10
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"want q (B, S, H, Dh) and k/v (B, S, Hkv, Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, Dh = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (B, S, Dh):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, S, Hkv, Dh) of q {tuple(q.shape)}")
    if S < 1 or k.shape[2] < 1 or H % k.shape[2] != 0:
        raise ValueError(f"need S >= 1 and H ({H}) divisible by Hkv "
                         f"({k.shape[2]})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention inputs lie on different devices")


def _check_card(q, k, v):
    """What the kernels take on the card, beyond ``_check``."""
    B, S, H, Dh = q.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention on cuda takes Dh in {HEAD_DIMS}, "
                         f"not {Dh}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q, k and v")
    if B * H > 65535:
        raise ValueError(f"flash_attention takes B·H <= 65535, not {B * H}")


def _raise_on(err: int, what: str):
    if err >= ENCODE_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed: "
                           f"CUresult {err - ENCODE_ERROR}")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _forward(q, k, v, causal: bool, with_lse: bool):
    """The forward on its device: ``o``, or ``(o, lse)`` with the rows'
    log-sum-exp ``(B, H, S)`` f32."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check_card(q, k, v)
    B, S, H, Dh = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    scale_log2 = Dh ** -0.5 * math.log2(math.e)
    with torch.cuda.device(q.device):         # the launch targets this card
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                        B, S, H, k.shape[2], Dh, TEMPLATE_WIDTH[Dh],
                        int(q.dtype == torch.bfloat16), int(causal),
                        scale_log2, stream)
    _raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """The gradient of ``flash_attention``: q, o, do (B, S, H, Dh), k/v
    (B, S, Hkv, Dh), lse (B, H, S) f32 from the forward → (dq, dk, dv) in
    the inputs' dtype.  On the card: the kernels of
    ``csrc/flash_attention_bwd.cu`` (bf16: the Hopper kernels, TMA ring +
    ``wgmma``; f32: SIMT), a q-tile kernel that forms D = rowsum(dO∘O) and
    writes dQ, then a kv-tile kernel that walks the group's q-heads and
    writes dK and dV once; on the CPU ``flash_attention_bwd_ref``."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be q's {tuple(q.shape)}")
    B, S, H, Dh = q.shape
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {H}, {S}) float32, not "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"o and do must be {q.dtype}; got {o.dtype}, "
                        f"{do.dtype}")
    if any(t.device != q.device for t in (o, lse, do)):
        raise ValueError("flash_attention_bwd inputs lie on different "
                         "devices")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not "
                         f"{q.device}")
    _check_card(q, k, v)
    if not all(t.is_contiguous() for t in (o, lse, do)):
        raise ValueError("flash_attention_bwd needs contiguous o, lse and do")
    if any(t.data_ptr() % 16 for t in (o, lse, do)):
        raise ValueError("flash_attention_bwd needs 16-byte aligned o, lse and "
                         "do")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    d_rows = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("flash_attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), d_rows.data_ptr(), B, S, H, k.shape[2], Dh,
            TEMPLATE_WIDTH[Dh], int(q.dtype == torch.bfloat16), int(causal),
            Dh ** -0.5, stream)
    _raise_on(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward saves ``q, k, v``,
    the output and its log-sum-exp; the backward is ``flash_attention_bwd``
    (the kernel on the card, the plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


class FlashAttentionFootprint(torch.autograd.Function):
    """``FlashAttention``'s allocations with no arithmetic: the forward's
    ``o`` and ``lse`` (saved with ``q, k, v``), the backward's contiguous
    ``do``, ``dq, dk, dv`` and ``d_rows`` (freed on return), each empty."""

    @staticmethod
    def forward(ctx, q, k, v):
        B, S, H, _ = q.shape
        out = torch.empty_like(q)
        lse = q.new_empty((B, H, S), dtype=torch.float32)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, _, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        d_rows = torch.empty_like(lse)
        del do, d_rows
        return dq, dk, dv


@contextlib.contextmanager
def footprint():
    """Within: ``flash_attention`` allocates what the kernels allocate and
    computes nothing (``FlashAttentionFootprint``), on every device."""
    was = _FOOTPRINT["on"]
    _FOOTPRINT["on"] = True
    try:
        yield
    finally:
        _FOOTPRINT["on"] = was


def _kv_for_heads(k, v, h0: int, Hl: int, group: int):
    """The kv heads local q heads h0..h0+Hl-1 read (head h reads kv head
    h // group), laid out so that local head i reads local kv head
    i // (Hl // kv heads): a slice where the q heads cover whole groups or
    lie in one, else one kv head per q head."""
    if Hl % group == 0 or group % Hl == 0:
        a = h0 // group
        b = (h0 + Hl - 1) // group + 1
        return k[:, :, a:b].contiguous(), v[:, :, a:b].contiguous()
    idx = torch.div(torch.arange(h0, h0 + Hl, device=k.device), group,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def _sharded(q, k, v, causal: bool):
    """``flash_attention`` of DTensors, per shard (see the module
    docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    q_in, kv_in, kv_grad = [], [], []
    head_axis = None
    for j, pl in enumerate(q.placements):
        n = mesh.size(j)
        if pl.is_shard(0):
            q_in.append(Shard(0))
            kv_in.append(Shard(0))
            kv_grad.append(Shard(0))
        elif pl.is_shard(2) and head_axis is None and H % n == 0:
            q_in.append(Shard(2))
            if Hkv % n == 0:
                kv_in.append(Shard(2))
                kv_grad.append(Shard(2))
            else:
                head_axis = j
                kv_in.append(Replicate())
                kv_grad.append(Partial())
        else:
            q_in.append(Replicate())
            kv_in.append(Replicate())
            kv_grad.append(Replicate())
    h0 = (0 if head_axis is None
          else mesh.get_local_rank(head_axis) * (H // mesh.size(head_axis)))

    def local(ql, kl, vl):
        ql = ql.contiguous()
        if head_axis is not None:
            kl, vl = _kv_for_heads(kl, vl, h0, ql.shape[2], H // Hkv)
        return flash_attention(ql, kl.contiguous(), vl.contiguous(), causal)
    q_in, kv_in, kv_grad = tuple(q_in), tuple(kv_in), tuple(kv_grad)
    return local_map(local, out_placements=list(q_in),
                     in_placements=(q_in, kv_in, kv_in),
                     in_grad_placements=(q_in, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def flash_attention(q, k, v, causal: bool = True):
    """q (B, S, H, Dh), k/v (B, S, Hkv, Dh) → (B, S, H, Dh) in q's dtype.
    Differentiable through ``FlashAttention`` when grad is enabled and an
    input requires it; otherwise the forward alone, with no log-sum-exp.
    On ``meta``, the plain version under ordinary autograd; DTensors run
    per shard (``_sharded``); within ``footprint()`` the kernels'
    allocations alone."""
    if is_dtensor(q):
        return _sharded(q, k, v, causal)
    if _FOOTPRINT["on"]:
        _check(q, k, v)
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FlashAttentionFootprint.apply(q, k, v)
        return torch.empty_like(q)
    if q.device.type == "meta":
        _check(q, k, v)
        return flash_attention_ref(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
