"""``cache_gather``: the feature plane's device-side row fetch.

Replaces the TPU kernel ``src/repro/kernels/gather/kernel.py:cache_gather_pallas``
with the hand-written CUDA kernel ``kernels/csrc/gather.cu``.

Contract (that of ``src/repro/kernels/gather/ops.py``): ``slots (n,) int32``
(−1 = miss) and ``cache (C, F)`` → ``(out (n, F) of cache.dtype, miss (n,)
int32)`` for any n ≥ 1 and any F, f32 or bf16.  No padding is needed: the
kernel masks nothing, it walks exactly n rows of exactly F columns.

Bound: bytes — ``(hits + n)·F·itemsize + 8n`` over the card's HBM rate.
Each warp reads the slots of a run of 32 rows in one load and issues all
its row loads before it stores any, in 16-byte words where the row width
and alignment allow (see the note in the CUDA source).

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the kernel or raises.  ``cache_gather.launches`` counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.gather.ref import cache_gather_ref

_DTYPES = (torch.float32, torch.bfloat16)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load
        fn = load("gather").cache_gather_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(slots: torch.Tensor, cache: torch.Tensor):
    if slots.dtype != torch.int32:
        raise TypeError(f"slots must be int32, got {slots.dtype}")
    if cache.dtype not in _DTYPES:
        raise TypeError(f"cache must be float32 or bfloat16, got {cache.dtype}")
    if slots.dim() != 1 or cache.dim() != 2:
        raise ValueError(f"want slots (n,) and cache (C, F); got "
                         f"{tuple(slots.shape)} and {tuple(cache.shape)}")
    if slots.shape[0] < 1 or cache.shape[0] < 1:
        raise ValueError("cache_gather needs n >= 1 slots and C >= 1 rows")
    if slots.device != cache.device:
        raise ValueError(f"slots on {slots.device}, cache on {cache.device}")


def cache_gather(slots: torch.Tensor, cache: torch.Tensor):
    """slots (n,) int32 (−1 miss) → (features (n, F), miss (n,) int32)."""
    _check(slots, cache)
    if slots.device.type == "cpu":
        return cache_gather_ref(slots, cache)
    if slots.device.type != "cuda":
        raise ValueError(f"cache_gather runs on cpu or cuda, not {slots.device}")
    if not (slots.is_contiguous() and cache.is_contiguous()):
        raise ValueError("cache_gather needs contiguous slots and cache")
    n, (C, F) = slots.shape[0], cache.shape
    out = torch.empty((n, F), dtype=cache.dtype, device=cache.device)
    miss = torch.empty((n,), dtype=torch.int32, device=cache.device)
    with torch.cuda.device(cache.device):     # the launch targets this card
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(slots.data_ptr(), cache.data_ptr(), out.data_ptr(),
                        miss.data_ptr(), n, C, F * cache.element_size(),
                        stream)
    if err != 0:
        raise RuntimeError(f"cache_gather launch failed: CUDA error {err}")
    cache_gather.launches += 1
    return out, miss


cache_gather.launches = 0
