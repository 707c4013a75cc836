"""KV-cache management for batched serving.

Contiguous per-request rows inside the stacked (L, B, T, Hkv, Dh) cache the
model families expose (models/*.cache_decls), and the per-slot ``ssm`` and
``conv`` states of the SSM and hybrid families.  The manager tracks
per-slot lengths and free slots so the engine can run continuous batching:
finished requests release their row, new prompts prefill into it.  A
released row is not cleared: attention masks its stale keys by position,
while an SSM state carries over into the next request (as in JAX).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class SlotState:
    active: bool = False
    length: int = 0
    request_id: int = -1


class KVCacheManager:
    """Slot allocator over a fixed-batch cache pytree."""

    def __init__(self, caches, batch: int, max_len: int):
        self.caches = caches
        self.batch = batch
        self.max_len = max_len
        self.slots = [SlotState() for _ in range(batch)]

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.active]

    def allocate(self, request_id: int, prompt_len: int) -> Optional[int]:
        free = self.free_slots()
        if not free or prompt_len >= self.max_len:
            return None
        slot = free[0]
        self.slots[slot] = SlotState(True, prompt_len, request_id)
        return slot

    def advance(self, slot: int):
        self.slots[slot].length += 1

    def release(self, slot: int) -> int:
        rid = self.slots[slot].request_id
        self.slots[slot] = SlotState()
        return rid

    def positions(self) -> np.ndarray:
        """Current write position per slot (0 for inactive — masked)."""
        return np.array([s.length if s.active else 0 for s in self.slots],
                        np.int32)

    def utilization(self) -> float:
        return sum(s.active for s in self.slots) / max(self.batch, 1)
