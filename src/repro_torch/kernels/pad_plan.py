"""Memoized pad plans for the aggregation kernels.

Every fused/segment aggregation call pads its row counts to block
multiples (and the feature width to a lane-aligned block) before
dispatch.  The shape arithmetic is pure Python and identical for every
same-shape batch — the training loop presents the SAME (n, F, fanout)
tuple thousands of times — so the plans are memoized here, per key,
with hit/miss counters that make the reuse testable
(tests/test_fused_agg.py) and visible in benchmarks.

Both kernel wrappers (kernels/segment_agg/ops.py and
kernels/fused_gather_agg/ops.py) and the host-side bucketing in
core/feature_plane.py route their shape math through ``pad_plan``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

_PLANS: Dict[tuple, tuple] = {}
_STATS = {"hits": 0, "misses": 0}


def pad_plan(kind: str, key: tuple, compute: Callable[[], tuple]) -> tuple:
    """Return the cached plan for (kind, key), computing it on first use."""
    k = (kind, key)
    plan = _PLANS.get(k)
    if plan is not None:
        _STATS["hits"] += 1
        return plan
    _STATS["misses"] += 1
    plan = _PLANS[k] = compute()
    return plan


def plan_stats() -> Dict[str, int]:
    return {**_STATS, "entries": len(_PLANS)}


def reset_plan_stats(clear_plans: bool = False) -> None:
    _STATS["hits"] = _STATS["misses"] = 0
    if clear_plans:
        _PLANS.clear()


# -- shared plan shapes ------------------------------------------------------

def round_up(n: int, block: int) -> int:
    return -(-n // block) * block


def row_plan(n: int, block: int = 8) -> int:
    """Padded row count: ``n`` rounded up to a multiple of ``block``."""
    (p,) = pad_plan("rows", (n, block), lambda: (round_up(n, block),))
    return p


def feat_plan(F: int) -> Tuple[int, int]:
    """Feature blocking: full-width when one block suffices, else a
    lane-aligned block size that divides the (padded) width.  Returns
    ``(block_f, padded_F)``."""
    def compute():
        if F <= 512:
            return F, F
        block_f = 512 if F % 512 == 0 else 128
        return block_f, round_up(F, block_f)
    return pad_plan("feat", (F,), compute)


def bucket_plan(n: int, min_rows: int = 8) -> int:
    """Pow2 bucket (≥ ``min_rows``) — the host-side padding discipline of
    core/feature_plane.py, memoized with the same counters."""
    def compute():
        return (max(1 << (max(n, 1) - 1).bit_length(), min_rows),)
    (p,) = pad_plan("bucket", (n, min_rows), compute)
    return p
