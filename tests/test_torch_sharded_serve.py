"""The sharded block prefill and decode step of every LM family
(``launch.group.sharded_serve_rank``: DTensors on a (data, model) mesh)
against the same steps unsharded.

Over 4 ``gloo`` CPU ranks as (2, 2) and (1, 4) (one spawn running both
in turn), for llama3.2-3b, qwen2-moe-a2.7b, mamba2-1.3b, zamba2-7b,
whisper-medium and qwen2-vl-2b at smoke size, f32, from JAX's converted weights (whisper's re-scaled as
``tests/test_torch_sharded_families.py`` does), the prompt and frontends
from a numpy seed: the prefill's last-token logits and every cache it
builds, then one decode step from a seeded cache (its logits and every
cache it writes), within 1e-5 of the unsharded ones (logits absolute;
each cache relative to its largest magnitude, at least 1: zamba2's k
cache reaches 18).  zamba2's weights are re-scaled as whisper's are:
from JAX's init as it is, 1e-7 relative noise on the embedding table
moves its unsharded prefill logits by 1.9e-5.  The SSM's
decode step gathers the ``in_proj`` output and the conv cache on each
rank's batch rows and keeps its own heads' state; a mesh of 4 does not
divide the smoke mamba2's ``in_proj`` output (296 wide), so there it is
replicated on ``model``.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.launch.group import sharded_serve_rank
from test_torch_sharded_families import family_spec, group_results

ATOL = 1e-5
TAME = {"zamba2-7b": {"init": "fan_in"}}
MESHES = [(2, 2), (1, 4)]
ARCHS = ["llama3.2-3b", "qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-7b",
         "whisper-medium", "qwen2-vl-2b"]


def _close(got: dict, want: dict, label: str):
    assert set(got) == set(want), (label, set(got), set(want))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (label, k, g.shape, w.shape)
        err = float((g.float() - w.float()).abs().max())
        scale = 1.0 if k == "logits" else max(1.0, float(w.abs().max()))
        assert err <= ATOL * scale, (label, k, err, scale)


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_unsharded(arch, sizes):
    torch.set_num_threads(1)
    spec = family_spec(arch, sizes, **TAME.get(arch, {}))
    ref = sharded_serve_rank(0, "cpu", spec)
    outs = group_results(sharded_serve_rank, arch, sizes, MESHES,
                         **TAME.get(arch, {}))
    for r, out in enumerate(outs):
        for part in ("prefill", "decode"):
            _close({"logits": out[f"{part}_logits"],
                    **out[f"{part}_caches"]},
                   {"logits": ref[f"{part}_logits"],
                    **ref[f"{part}_caches"]}, (r, part))
        assert not {"jax", "repro"} & set(out["modules"])
