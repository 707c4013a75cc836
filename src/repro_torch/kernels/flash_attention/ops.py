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

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the kernel or raises.  ``flash_attention.launches`` counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
# the head widths the card takes, each with the kernels' template width it
# runs on (the narrowest of 16, 32, 64 and 128 that holds it); the CUDA
# source is told the template at every launch
TEMPLATE_WIDTH = {8: 16, 16: 16, 32: 32, 64: 64, 112: 128, 128: 128}
HEAD_DIMS = tuple(TEMPLATE_WIDTH)
ENCODE_ERROR = 100000      # the C function's code: this + a CUresult
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load
        fn = load("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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


def flash_attention(q, k, v, causal: bool = True):
    """q (B, S, H, Dh), k/v (B, S, Hkv, Dh) → (B, S, H, Dh) in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
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
    out = torch.empty_like(q)
    scale_log2 = Dh ** -0.5 * math.log2(math.e)
    with torch.cuda.device(q.device):         # the launch targets this card
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, S, H, k.shape[2], Dh,
                        TEMPLATE_WIDTH[Dh], int(q.dtype == torch.bfloat16), int(causal),
                        scale_log2, stream)
    if err >= ENCODE_ERROR:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed: "
                           f"CUresult {err - ENCODE_ERROR}")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
