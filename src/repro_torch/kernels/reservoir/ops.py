"""``reservoir_topm``: Efraimidis–Spirakis weighted top-m over neighbour rows.

Replaces the TPU kernel
``src/repro/kernels/reservoir/kernel.py:reservoir_topm_pallas`` with the
hand-written CUDA kernels of ``kernels/csrc/reservoir.cu``.

Contract (that of ``src/repro/kernels/reservoir/ops.py``): ``weights`` and
``u`` (R, N), float32 or any real type cast to it; ``mask`` (R, N), bool or
integer, nonzero = valid; any R ≥ 1, N ≥ 1 and m ≥ 1 (m > N too).  Keys are
``log(max(u, 1e-30)) / max(w, 1e-9)``; the result is ``(idx (R, m) int32,
keys (R, m) float32)``, the m largest valid keys of each row in descending
order, ties to the lower lane; a round past a row's last valid lane gives
``idx == N`` and ``key == -3.0e38``.  The JAX wrapper pads rows to 8 and
lanes to 128 for the TPU's tiles and maps the padded width back to N; the
port pads nothing.

Bound: bytes — ``R·N·(8 + mask bytes) + 8·R·m`` over the card's HBM rate
(see the note in the CUDA source).  The mask is read as given: 1 byte for
bool, int8 and uint8, 4 for int32; other integer masks are turned to bool
first.

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the kernel or raises.  ``reservoir_topm.launches`` counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import operator

import torch

from repro_torch.kernels.reservoir.ref import reservoir_topm_ref

_MASK_1B = (torch.bool, torch.int8, torch.uint8)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load
        fn = load("reservoir").reservoir_topm_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
            + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _real(t: torch.Tensor) -> bool:
    return t.dtype != torch.bool and not t.is_complex()


def _check(weights, u, mask, m):
    if not (_real(weights) and _real(u)):
        raise TypeError(f"weights and u must be real numbers, got "
                        f"{weights.dtype} and {u.dtype}")
    if mask.is_floating_point() or mask.is_complex():
        raise TypeError(f"mask must be bool or integer, got {mask.dtype}")
    if weights.dim() != 2 or not weights.shape == u.shape == mask.shape:
        raise ValueError(f"want weights, u and mask of one shape (R, N); got "
                         f"{tuple(weights.shape)}, {tuple(u.shape)} and "
                         f"{tuple(mask.shape)}")
    R, N = weights.shape
    if R < 1 or N < 1 or m < 1:
        raise ValueError(f"reservoir_topm needs R, N and m >= 1; got R={R}, "
                         f"N={N}, m={m}")
    if N > 2**30 or m > 2**30:
        raise ValueError(f"N={N} or m={m} is past the kernel's int32 range")
    if not weights.device == u.device == mask.device:
        raise ValueError(f"weights on {weights.device}, u on {u.device}, "
                         f"mask on {mask.device}")


def reservoir_topm(weights: torch.Tensor, u: torch.Tensor, mask: torch.Tensor,
                   m: int):
    """weights/u (R, N), mask (R, N) → (idx (R, m) int32, keys (R, m)
    float32); idx == N marks an exhausted round."""
    m = operator.index(m)
    _check(weights, u, mask, m)
    dev = weights.device
    if dev.type == "cpu":
        return reservoir_topm_ref(weights.float(), u.float(), mask, m)
    if dev.type != "cuda":
        raise ValueError(f"reservoir_topm runs on cpu or cuda, not {dev}")
    if not (weights.is_contiguous() and u.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("reservoir_topm needs contiguous weights, u and mask")
    weights, u = weights.float(), u.float()
    if mask.dtype in _MASK_1B:
        mask, mask_bytes = mask.view(torch.uint8), 1
    elif mask.dtype == torch.int32:
        mask_bytes = 4
    else:
        mask, mask_bytes = (mask != 0).view(torch.uint8), 1
    R, N = weights.shape
    idx = torch.empty((R, m), dtype=torch.int32, device=dev)
    keys = torch.empty((R, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):              # the launch targets this card
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(weights.data_ptr(), u.data_ptr(), mask.data_ptr(),
                        mask_bytes, idx.data_ptr(), keys.data_ptr(), R, N, m,
                        stream)
    if err != 0:
        raise RuntimeError(f"reservoir_topm launch failed: CUDA error {err}")
    reservoir_topm.launches += 1
    return idx, keys


reservoir_topm.launches = 0
