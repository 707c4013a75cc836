"""Carry GNN parameters between the JAX package and the port.

Both keep ``{"layers": [{name: array}]}`` with ``(din, dout)`` weights, so
the mapping is by name and nothing is transposed.  The JAX side is handed
over as numpy arrays (``np.asarray`` of each leaf); this module never
imports JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(tree: Dict, device="cuda") -> Dict:
    """``{"layers": [{name: array-like}]}`` → the port's tensors on
    ``device``, in each array's own dtype."""
    return {"layers": [{k: torch.from_numpy(np.array(v)).to(device)
                        for k, v in layer.items()}
                       for layer in tree["layers"]]}


def params_to_numpy(params: Dict) -> Dict:
    """The port's parameters → ``{"layers": [{name: np.ndarray}]}``, the
    form the JAX package's functions accept."""
    return {"layers": [{k: v.detach().cpu().numpy() for k, v in layer.items()}
                       for layer in params["layers"]]}
