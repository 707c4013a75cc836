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

Bound: bytes — ``R·N·mask bytes + 8·valid lanes + 8·R·m`` over the card's
HBM rate (see the note in the CUDA source).  The mask is read as given: 1
byte for bool, int8 and uint8, 4 for int32; other integer masks are turned
to bool first.

``layout(N)`` is the launcher: narrow rows (N ≤ 32) as segments of a warp,
rows up to 2,048 lanes one block each, a wider row cut into chunks over
many blocks whose lists the last block to finish merges.  Each choice is
the fastest of every layout the kernel takes, timed on the sampler's own
hop buckets on the card (``scripts/reservoir_layouts.py``); on both hops
(different R, m = 10 and 5) choosing by N alone came within 0.0002 ms a
hop of every bucket's fastest layout.

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches the kernel or raises.  ``reservoir_topm.launches`` counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import operator
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels.reservoir.ref import reservoir_topm_ref

_MASK_1B = (torch.bool, torch.int8, torch.uint8)
WARP_LANES = 32
MAX_WARPS = 8             # warps of a chunked block (csrc: kMaxWarps)
# N <= 2048: one block a row of (keys a lane, warps); wider rows: 8 warps a
# chunk, 32 chunks a row up to 32 × 1,024 lanes (one merge level), past it
# 256 (two levels) of at least 256 lanes each
ONE_BLOCK = ((64, 2, 1), (128, 4, 1), (256, 8, 1), (512, 2, 8), (1024, 4, 8),
             (2048, 8, 8))
ONE_LEVEL_CHUNKS, ONE_LEVEL_MAX_LANES = 32, 1024
_fns = None
_counters = {}
_counters_lock = threading.Lock()


class Layout(NamedTuple):
    """``seg`` > 0: the narrow kernel, rows as segments of ``seg`` lanes.
    Else the chunked kernel: ``K`` keys a lane, ``W`` warps a block, ``P``
    chunks (blocks) a row of ``S`` sub-chunks of ``W·32·K`` lanes each."""
    seg: int = 0
    K: int = 0
    W: int = 0
    P: int = 0
    S: int = 0

    @property
    def chunk_lanes(self) -> int:
        """Lanes of one block's chunk of a row (N for the narrow kernel)."""
        return self.S * self.W * WARP_LANES * self.K

    @property
    def warp_lanes(self) -> int:
        return WARP_LANES * self.K


def chunked(N: int, K: int, W: int, P: int) -> Layout:
    """(K, W) with at most ``P`` chunks a row, sub-chunks where the final
    merge's 32·W lists do not hold that many."""
    subs = -(-N // (W * WARP_LANES * K))
    P = min(P, subs, WARP_LANES * W)
    S = -(-subs // P)
    return Layout(0, K, W, -(-subs // S), S)


def _pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def layout(N: int) -> Layout:
    """The launcher's layout for rows of N lanes."""
    if N <= WARP_LANES:
        return Layout(seg=_pow2(N))
    for top, K, W in ONE_BLOCK:
        if N <= top:
            return Layout(0, K, W, 1, 1)
    block = MAX_WARPS * WARP_LANES
    if N <= ONE_LEVEL_CHUNKS * ONE_LEVEL_MAX_LANES:
        lanes = _pow2(-(-N // ONE_LEVEL_CHUNKS))
    else:
        lanes = _pow2(-(-N // (WARP_LANES * MAX_WARPS)))
    K = min(max(lanes, block) // block, 8)
    return chunked(N, K, MAX_WARPS, N)


def _kernel():
    global _fns
    if _fns is None:
        from repro_torch.kernels.build import load
        lib = load("reservoir")
        fn = lib.reservoir_topm_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
            + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        nbytes = lib.reservoir_topm_scratch_bytes
        nbytes.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 7
        nbytes.restype = ctypes.c_longlong
        _fns = fn, nbytes
    return _fns


def _zeroed_counters(dev, stream: int, rows: int) -> torch.Tensor:
    """``rows`` zeroed ints for the last-block tickets of a launch on
    ``stream``.  Every launch leaves them at 0, so one buffer serves every
    launch of a stream; a larger one replaces it when R grows."""
    key = (dev.index, stream)
    with _counters_lock:
        buf = _counters.get(key)
        if buf is None or buf.numel() < rows:
            buf = torch.zeros(max(rows, 2 * (0 if buf is None
                                             else buf.numel())),
                              dtype=torch.int32, device=dev)
            _counters[key] = buf
        return buf


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
                   m: int, *, plan: Layout | None = None):
    """weights/u (R, N), mask (R, N) → (idx (R, m) int32, keys (R, m)
    float32); idx == N marks an exhausted round.  ``plan`` replaces the
    launcher's layout (to time layouts against each other)."""
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
    launch, scratch_bytes = _kernel()
    if plan is None:
        plan = layout(N)
    nbytes = scratch_bytes(R, N, m, *plan)
    if nbytes < 0:
        raise ValueError(f"layout {plan} does not fit ({R}, {N}) rows")
    idx = torch.empty((R, m), dtype=torch.int32, device=dev)
    keys = torch.empty((R, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):              # the launch targets this card
        stream = torch.cuda.current_stream().cuda_stream
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        counters = (_zeroed_counters(dev, stream, R) if plan.P > 1
                    else None)
        err = launch(weights.data_ptr(), u.data_ptr(), mask.data_ptr(),
                     mask_bytes, idx.data_ptr(), keys.data_ptr(), R, N, m,
                     *plan, scratch.data_ptr() if nbytes else None,
                     None if counters is None else counters.data_ptr(),
                     stream)
    if err != 0:
        raise RuntimeError(f"reservoir_topm launch failed: CUDA error {err}")
    reservoir_topm.launches += 1
    return idx, keys


reservoir_topm.launches = 0
