"""The sharded train step of whisper-medium (2 encoder and 2 decoder
layers; its weights JAX's re-scaled to N(0, 1 / the whole fan-in, as
``tests/test_torch_sharded_families.py`` explains) and qwen2-vl-2b (a
vision prefix and M-RoPE positions from a numpy seed) over ``gloo`` CPU
ranks as (2, 2), (4, 1), (1, 4) and (1, 2), held to the unsharded step
and to the dry-run's trace as that file holds the SSM families: the
encoder's self-attention and the cross attention per head shard, each
frontend placed by its own spec."""
from __future__ import annotations

import pytest

from test_torch_sharded_families import (MESHES, _hold_to_unsharded,
                                         tracer)  # noqa: F401 (a fixture)


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-2b"])
def test_sharded_family_step_matches_unsharded(arch, sizes, tracer):
    _hold_to_unsharded(arch, sizes, tracer)
