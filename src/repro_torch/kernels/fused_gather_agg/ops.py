"""``gather_aggregate``: the fused layer-0 read of the all-hop fused train
step.

Replaces the TPU kernel
``src/repro/kernels/fused_gather_agg/kernel.py:gather_aggregate_pallas``
with the hand-written CUDA kernel ``kernels/csrc/fused_gather_agg.cu``.

Contract (that of ``src/repro/kernels/fused_gather_agg/ops.py``):
``enc (Ns,) int32`` says where each input id's feature row lives —
``enc[i] >= 0`` is a slot of the cache ``table (C, F)``, ``enc[i] < 0`` is
row ``-enc[i]-1`` of the sideband ``aux (Na, F)`` (Na ≥ 1).
``neigh_idx (Nd, fanout) int32`` indexes the input ids (−1 = pad), the dst
ids being the prefix of the input ids (``Nd ≤ Ns``).  Returns
``(h_dst (Nd, F), agg (Nd, F))``: the self rows and the masked neighbour
aggregate (``mode``: ``mean`` or ``sum``), without materializing the
(Ns, F) batch tensor.  Padded enc entries resolve to ``aux[0]``;
out-of-range slots clamp.  Any Nd and F: nothing is padded.

Forward only: the table and the sideband are not parameters, and the
outputs carry no gradient.

Bound: bytes (see the note in the CUDA source).  A tensor on the CPU takes
the plain version (``ref.py``); a CUDA tensor launches the kernel or
raises.  ``gather_aggregate.launches`` counts kernel launches, and nothing
else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.fused_gather_agg.ref import gather_aggregate_ref

_MODES = {"mean": 0, "sum": 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load
        fn = load("fused_gather_agg").gather_aggregate_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(enc, neigh_idx, table, aux, mode):
    if mode not in _MODES:
        raise ValueError(f"gather_aggregate mode must be mean or sum, "
                         f"got {mode!r}")
    if enc.dtype != torch.int32 or neigh_idx.dtype != torch.int32:
        raise TypeError(f"enc and neigh_idx must be int32, got {enc.dtype} "
                        f"and {neigh_idx.dtype}")
    if enc.dim() != 1 or neigh_idx.dim() != 2 or table.dim() != 2 \
            or aux.dim() != 2:
        raise ValueError("want enc (Ns,), neigh_idx (Nd, fanout), table "
                         "(C, F) and aux (Na, F)")
    if table.shape[1] != aux.shape[1] or table.shape[1] < 1:
        raise ValueError(f"table {tuple(table.shape)} and aux "
                         f"{tuple(aux.shape)} need one width F >= 1")
    if table.shape[0] < 1 or aux.shape[0] < 1:
        raise ValueError("gather_aggregate needs a table and a sideband "
                         "of at least one row each")
    if neigh_idx.shape[0] > enc.shape[0]:
        raise ValueError(f"Nd = {neigh_idx.shape[0]} dst rows exceed the "
                         f"Ns = {enc.shape[0]} input ids")
    dev = table.device
    if any(t.device != dev for t in (enc, neigh_idx, aux)):
        raise ValueError("gather_aggregate inputs lie on different devices")
    if dev.type == "cuda":
        if table.dtype != torch.float32 or aux.dtype != torch.float32:
            raise TypeError("gather_aggregate on cuda takes float32 rows")
        if not all(t.is_contiguous() for t in (enc, neigh_idx, table, aux)):
            raise ValueError("gather_aggregate needs contiguous inputs")
    elif dev.type != "cpu":
        raise ValueError(f"gather_aggregate runs on cpu or cuda, not {dev}")


def gather_aggregate(enc, neigh_idx, table, aux, mode: str = "mean"):
    """enc (Ns,) int32; neigh_idx (Nd, fanout) int32; table (C, F);
    aux (Na, F) → (h_dst (Nd, F), agg (Nd, F))."""
    _check(enc, neigh_idx, table, aux, mode)
    if table.device.type == "cpu":
        with torch.no_grad():
            return gather_aggregate_ref(enc, neigh_idx, table, aux, mode)
    ns, (nd, fan), (c, f) = enc.shape[0], neigh_idx.shape, table.shape
    h_dst = torch.empty((nd, f), dtype=table.dtype, device=table.device)
    agg = torch.empty((nd, f), dtype=table.dtype, device=table.device)
    if nd == 0:
        return h_dst, agg
    with torch.cuda.device(table.device):     # the launch targets this card
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(enc.data_ptr(), neigh_idx.data_ptr(),
                        table.data_ptr(), aux.data_ptr(), h_dst.data_ptr(),
                        agg.data_ptr(), ns, nd, fan, c, aux.shape[0], f,
                        _MODES[mode], stream)
    if err != 0:
        raise RuntimeError(f"gather_aggregate launch failed: CUDA error {err}")
    gather_aggregate.launches += 1
    return h_dst, agg


gather_aggregate.launches = 0
