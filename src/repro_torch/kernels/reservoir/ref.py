"""Plain PyTorch version of the reservoir top-m selection: the CPU path and
the oracle the CUDA kernel is held against.  Line for line the jnp oracle
of the JAX package (``src/repro/kernels/reservoir/ref.py``)."""
from __future__ import annotations

import torch

NEG = -3.0e38


def reservoir_topm_ref(weights, u, mask, m: int):
    """weights/u (R, N) float32, mask (R, N) nonzero = valid → (idx (R, m)
    int32, keys (R, m) float32).  An exhausted round gives idx N and key
    NEG."""
    keys = torch.log(torch.clamp(u, min=1e-30)) / torch.clamp(weights,
                                                              min=1e-9)
    keys = keys.masked_fill(mask == 0, NEG)
    R, npad = keys.shape
    iota = torch.arange(npad, dtype=torch.int32,
                        device=keys.device).expand(R, npad)
    idxs, kouts = [], []
    for _ in range(m):
        mx = keys.max(dim=1, keepdim=True).values
        is_max = (keys == mx) & (mx > NEG / 2)
        idx = torch.where(is_max, iota, npad).min(dim=1).values
        idxs.append(idx.to(torch.int32))
        kouts.append(mx[:, 0])
        keys = keys.masked_fill(iota == idx[:, None], NEG)
    return torch.stack(idxs, 1), torch.stack(kouts, 1)
