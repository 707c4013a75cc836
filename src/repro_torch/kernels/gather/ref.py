"""Plain PyTorch version of the cache gather: the CPU path and the oracle
the CUDA kernel is held against."""
from __future__ import annotations

import torch


def cache_gather_ref(slots: torch.Tensor, cache: torch.Tensor):
    """slots (n,) int (−1 = miss), cache (C, F) → (out (n, F) of
    ``cache.dtype``, miss (n,) int32).  Slots at or past C clamp to C − 1,
    as the JAX gather does."""
    hit = slots >= 0
    rows = cache[slots.clamp(0, cache.shape[0] - 1).long()]
    out = torch.where(hit[:, None], rows, torch.zeros((), dtype=cache.dtype,
                                                      device=cache.device))
    return out, (~hit).to(torch.int32)
