"""``neighbor_agg``: the per-hop fused aggregation of the GNN layers, with
its gradient.

Replaces the TPU kernel
``src/repro/kernels/segment_agg/kernel.py:neighbor_agg_pallas`` with the
hand-written CUDA kernels of ``kernels/csrc/segment_agg.cu``: a forward,
and a backward that the TPU kernel never had (the JAX train step
differentiates the jnp oracle instead).

Contract (that of ``src/repro/kernels/segment_agg/ops.py``):
``neigh_idx (Nd, fanout) int32`` (−1 = pad) and ``h_src (Ns, D) float32``
→ ``(Nd, D)``; ``mode`` is ``mean`` (GraphSAGE/GCN) or ``sum`` (GIN), and
``weights (Nd, fanout)`` (GAT attention) ride along only with
``mode="sum"`` — any other mode with weights raises ``ValueError``.  Any
Nd ≥ 1 and any D ≥ 1 (D = 47, D = 602): nothing is padded.  Rows whose
entries are all padding give 0.

``neighbor_agg`` is a ``torch.autograd.Function``: gradients reach
``h_src`` and ``weights`` through ``neighbor_agg_backward``, a kernel too.

Bound: bytes, both ways (see the note in the CUDA source).  The backward
pulls each ``dh_src`` row from a transposition of ``neigh_idx`` that it
builds on the card (a bucket of 32 entry ids per source row, longer
sources apart) and adds in ascending flat entry id, the order of the plain
version's ``index_add_``: it uses no float atomics, and its ``dh_src`` is
bit-equal to ``neighbor_agg_bwd_ref`` on the CPU and to itself from run to
run.  A tensor on the CPU takes the plain versions (``ref.py``); a CUDA
tensor launches the kernels or raises.  ``neighbor_agg.launches`` and
``neighbor_agg_backward.launches`` count calls that launched, and nothing
else: one per call (a backward call queues a memset and three kernels, four
when weighted).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.segment_agg.ref import (_check_mode,
                                                 neighbor_agg_bwd_ref,
                                                 neighbor_agg_ref)

_MODES = {"mean": 0, "sum": 1}
_WEIGHTED = 2
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load
        lib = load("segment_agg")
        lib.neighbor_agg_fwd_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
            + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
        lib.neighbor_agg_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int]
            + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
        lib.neighbor_agg_bwd_scratch_bytes.argtypes = [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
        lib.neighbor_agg_fwd_launch.restype = ctypes.c_int
        lib.neighbor_agg_bwd_launch.restype = ctypes.c_int
        lib.neighbor_agg_bwd_scratch_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _check(neigh_idx, h_src, mode, weights, dout=None):
    _check_mode(mode, weights)
    if neigh_idx.dtype != torch.int32:
        raise TypeError(f"neigh_idx must be int32, got {neigh_idx.dtype}")
    if neigh_idx.dim() != 2 or h_src.dim() != 2:
        raise ValueError(f"want neigh_idx (Nd, fanout) and h_src (Ns, D); got "
                         f"{tuple(neigh_idx.shape)} and {tuple(h_src.shape)}")
    if h_src.shape[0] < 1 or h_src.shape[1] < 1:
        raise ValueError("neighbor_agg needs h_src with Ns >= 1 and D >= 1")
    tensors = [neigh_idx, h_src]
    if weights is not None:
        if tuple(weights.shape) != tuple(neigh_idx.shape):
            raise ValueError(f"weights {tuple(weights.shape)} must match "
                             f"neigh_idx {tuple(neigh_idx.shape)}")
        tensors.append(weights)
    if dout is not None:
        if tuple(dout.shape) != (neigh_idx.shape[0], h_src.shape[1]):
            raise ValueError(f"dout {tuple(dout.shape)} must be (Nd, D)")
        tensors.append(dout)
    if any(t.device != h_src.device for t in tensors):
        raise ValueError("neighbor_agg inputs lie on different devices")
    if h_src.device.type == "cuda":
        floats = tensors[1:]
        if any(t.dtype != torch.float32 for t in floats):
            raise TypeError("neighbor_agg on cuda takes float32 rows, "
                            "weights and gradients")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("neighbor_agg needs contiguous inputs on cuda")
    elif h_src.device.type != "cpu":
        raise ValueError(f"neighbor_agg runs on cpu or cuda, not "
                         f"{h_src.device}")


def _mode_code(mode, weights) -> int:
    return _WEIGHTED if weights is not None else _MODES[mode]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(neigh_idx, h_src, mode, weights):
    _check(neigh_idx, h_src, mode, weights)
    if h_src.device.type == "cpu":
        return neighbor_agg_ref(neigh_idx, h_src, mode, weights)
    (nd, fan), (ns, d) = neigh_idx.shape, h_src.shape
    out = torch.empty((nd, d), dtype=h_src.dtype, device=h_src.device)
    if nd == 0:
        return out
    with torch.cuda.device(h_src.device):     # the launch targets this card
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels().neighbor_agg_fwd_launch(
            neigh_idx.data_ptr(), h_src.data_ptr(), _ptr(weights),
            out.data_ptr(), nd, fan, ns, d, _mode_code(mode, weights), stream)
    if err != 0:
        raise RuntimeError(f"neighbor_agg launch failed: CUDA error {err}")
    neighbor_agg.launches += 1
    return out


def neighbor_agg_backward(neigh_idx, dout, h_src, mode: str = "mean",
                          weights=None):
    """Gradient of ``neighbor_agg`` for the output gradient ``dout``
    (Nd, D): ``(dh_src (Ns, D), dw (Nd, fanout) or None)``; ``dw`` exists
    only for a weighted call."""
    _check(neigh_idx, h_src, mode, weights, dout)
    if h_src.device.type == "cpu":
        return neighbor_agg_bwd_ref(neigh_idx, dout, h_src, mode, weights)
    (nd, fan), (ns, d) = neigh_idx.shape, h_src.shape
    dw = (torch.empty((nd, fan), dtype=h_src.dtype, device=h_src.device)
          if weights is not None else None)
    if nd == 0:
        return torch.zeros_like(h_src), dw
    if nd * fan >= 2**31 or fan > 2**24:
        raise ValueError(f"neighbor_agg backward takes fewer than 2^31 "
                         f"entries and a fanout up to 2^24, got {nd} x {fan}")
    lib = _kernels()
    dh = torch.empty((ns, d), dtype=h_src.dtype, device=h_src.device)
    scratch = torch.empty(lib.neighbor_agg_bwd_scratch_bytes(nd, fan, ns),
                          dtype=torch.uint8, device=h_src.device)
    with torch.cuda.device(h_src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.neighbor_agg_bwd_launch(
            neigh_idx.data_ptr(), dout.data_ptr(), h_src.data_ptr(),
            _ptr(weights), dh.data_ptr(), _ptr(dw), scratch.data_ptr(), nd,
            fan, ns, d, _mode_code(mode, weights), stream)
    if err != 0:
        raise RuntimeError(f"neighbor_agg backward launch failed: CUDA error "
                           f"{err}")
    neighbor_agg_backward.launches += 1
    return dh, dw


class _NeighborAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, neigh_idx, h_src, weights, mode):
        ctx.mode = mode
        ctx.save_for_backward(neigh_idx, h_src, weights)
        return _forward(neigh_idx, h_src, mode, weights)

    @staticmethod
    def backward(ctx, dout):
        neigh_idx, h_src, weights = ctx.saved_tensors
        dh, dw = neighbor_agg_backward(neigh_idx, dout.contiguous(), h_src,
                                       ctx.mode, weights)
        return None, dh, dw, None


def neighbor_agg(neigh_idx, h_src, mode: str = "mean", weights=None):
    """neigh_idx (Nd, fanout) int32 (−1 pad); h_src (Ns, D) float32;
    weights (Nd, fanout) or None (then ``mode="sum"``) → (Nd, D)."""
    _check_mode(mode, weights)
    return _NeighborAgg.apply(neigh_idx, h_src, weights, mode)


def neighbor_mean(neigh_idx, h_src):
    return neighbor_agg(neigh_idx, h_src, mode="mean")


neighbor_agg.launches = 0
neighbor_agg_backward.launches = 0
