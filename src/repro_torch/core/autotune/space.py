"""Design space (paper Table I) — encode/decode/clip for the PPO agent.

Every knob is normalized to [0,1] for the agent; ``decode`` maps back to a
concrete configuration dict.  The same vector feeds the surrogate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

MODES = ("seq", "mode1", "mode2")
DEVICES = ("cpu", "device")


@dataclass(frozen=True)
class Knob:
    name: str
    kind: str                    # int | float | cat | log
    lo: float = 0.0
    hi: float = 1.0
    choices: Tuple = ()

    def decode(self, u: float):
        u = float(np.clip(u, 0.0, 1.0))
        if self.kind == "cat":
            i = min(int(u * len(self.choices)), len(self.choices) - 1)
            return self.choices[i]
        if self.kind == "int":
            return int(round(self.lo + u * (self.hi - self.lo)))
        if self.kind == "log":
            return float(np.exp(np.log(self.lo) + u * (np.log(self.hi)
                                                       - np.log(self.lo))))
        return self.lo + u * (self.hi - self.lo)

    def encode(self, v) -> float:
        if self.kind == "cat":
            return (self.choices.index(v) + 0.5) / len(self.choices)
        if self.kind == "log":
            return float((np.log(v) - np.log(self.lo))
                         / (np.log(self.hi) - np.log(self.lo)))
        return float((v - self.lo) / (self.hi - self.lo))


def design_space(max_partitions: int = 8, max_workers: int = 8,
                 max_cache_mb: float = 512.0) -> List[Knob]:
    """Table I: general / sampling / feature / parallelism knobs."""
    return [
        Knob("batch_size", "int", 64, 1024),
        Knob("partitions", "int", 1, max_partitions),
        Knob("bias_rate", "log", 1.0, 16.0),
        Knob("sampling_device", "cat", choices=DEVICES),
        Knob("workers", "int", 1, max_workers),
        Knob("cache_volume_mb", "log", 1.0, max_cache_mb),
        Knob("parallel_mode", "cat", choices=MODES),
    ]


class Space:
    def __init__(self, knobs: List[Knob] | None = None):
        self.knobs = knobs or design_space()

    @property
    def dim(self) -> int:
        return len(self.knobs)

    def decode(self, u: np.ndarray) -> Dict:
        return {k.name: k.decode(x) for k, x in zip(self.knobs, u)}

    def encode(self, cfg: Dict) -> np.ndarray:
        return np.array([k.encode(cfg[k.name]) for k in self.knobs])

    def clip(self, u: np.ndarray) -> np.ndarray:
        return np.clip(u, 0.0, 1.0)

    def sample(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        return rng.random((n, self.dim))

    def grid(self, points_per_dim: int = 3) -> np.ndarray:
        """Full-factorial grid (the paper's grid-search baseline)."""
        axes = [np.linspace(0.05, 0.95, points_per_dim)] * self.dim
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.stack([m.ravel() for m in mesh], axis=-1)
