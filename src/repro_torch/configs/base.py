"""Architecture registry: ``--arch <id>`` → config factory.

The port registers the GNN configs only (configs/gnn.py); the LM
architectures of the JAX package are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List

_REGISTRY: Dict[str, Any] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, smoke: bool = False):
    import repro_torch.configs as _pkg  # noqa: F401  (triggers arch module imports)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](smoke=smoke)


def list_archs() -> List[str]:
    import repro_torch.configs as _pkg  # noqa: F401
    return sorted(_REGISTRY)
