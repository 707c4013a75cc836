"""The sharded LM step (``torch.distributed.tensor`` DTensors on a (data,
model) mesh) against the unsharded port step and against the dry-run's
collective count.

  * ``placements`` and ``constrain``: a DTensor's local shard holds
    ``shard_bytes`` of its spec on (2, 2), (16, 16) and (2, 16, 16), for
    every leaf of every LM arch (on ``meta``, over a fake group);
  * the step (``launch.group.sharded_lm_rank``) over 4 ``gloo`` CPU ranks
    as (2, 2), (4, 1) and (1, 4), and over 2 as (1, 2), for llama3.2-3b
    and qwen2-moe-a2.7b at smoke size from JAX's converted weights, held
    to the unsharded port step run under ``shard_ctx`` of an
    ``AbstractMesh`` of the same shape (the MoE groups its tokens alike):
    the loss and every gradient within 1e-5 abs (f32), the parameters
    after 2 AdamW steps (and, at (2, 2), 2 Adafactor steps) within 1e-4
    of each leaf's largest magnitude;
  * the bytes each rank's collectives moved in its step, by op, equal to
    ``launch.dryrun.count_collectives`` of the same config, shape and mesh
    (the ``meta`` trace over a fake group);
  * the trace's call sites: each activation's partial sum reduced where
    it is made, in the compute dtype, and the global norm reduced once.
"""
from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import (P, constrain, enforce_divisible,
                                              physical_specs, placements,
                                              resolve_spec, shard_bytes,
                                              shard_ctx)
from repro_torch.launch import dryrun
from repro_torch.launch.group import sharded_lm_rank, spawn_partitions
from repro_torch.launch.mesh import (AbstractMesh, fake_device_mesh,
                                     release_fake_group)
from repro_torch.models.api import build
from repro_torch.models.params import leaves

ATOL = 1e-5                # loss and gradients, f32
PARAM_REL = 1e-4           # parameters after 2 AdamW steps, of a leaf's max
B, S, LAYERS = 8, 16, 2
MESHES = [(2, 2), (4, 1), (1, 4), (1, 2)]
ARCHS = ["llama3.2-3b", "qwen2-moe-a2.7b"]


@pytest.fixture
def fake_group():
    yield fake_device_mesh
    release_fake_group()


@pytest.mark.parametrize("sizes", [(2, 2), (16, 16), (2, 16, 16)])
def test_placements_hold_shard_bytes(sizes, fake_group):
    axes = ("data", "model") if len(sizes) == 2 else ("pod", "data", "model")
    mesh = AbstractMesh(sizes, axes)
    dm = fake_group(mesh)
    n = 0
    for arch in dryrun.lm_archs():
        cfg = get_config(arch)
        decls = build(cfg).decls
        for d, spec in zip(leaves(decls),
                           leaves(physical_specs(decls, cfg, mesh))):
            t = dryrun.meta_dtensor(d.shape, d.dtype, spec, dm)
            local = t.to_local()
            assert local.numel() * local.element_size() == shard_bytes(
                d.shape, d.dtype.itemsize, spec, mesh), (arch, d.shape, spec)
            n += 1
    assert n > 100


@pytest.mark.parametrize("sizes", [(2, 2), (16, 16), (2, 16, 16)])
@pytest.mark.parametrize("axes", [("dp", None, None),
                                  ("dp", None, "qheads", None),
                                  ("dp", "kvseq", "kvheads", None)])
def test_constrain_holds_shard_bytes(sizes, axes, fake_group):
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data",
                                                        "model")
    mesh = AbstractMesh(sizes, names)
    dm = fake_group(mesh)
    cfg = get_config("qwen3-4b")
    shape = (256, 64, 32, 128)[:len(axes)]
    x = dryrun.meta_dtensor(shape, torch.bfloat16, P(), dm)
    assert constrain(x, *axes) is x            # no context: an identity
    with shard_ctx(cfg, mesh, dm):
        y = constrain(x, *axes)
        spec = enforce_divisible(resolve_spec(P(*axes), dryrun.make_rules(
            cfg, mesh)), shape, mesh)
        assert tuple(y.placements) == placements(spec, dm)
    local = y.to_local()
    assert local.numel() * 2 == shard_bytes(shape, 2, spec, mesh)


def _spec(arch, sizes, overrides, seed=0):
    jcfg = jx_get_config(arch, smoke=True).replace(
        num_layers=LAYERS, param_dtype="float32", compute_dtype="float32",
        **overrides)
    jp = jx_init(jx_build(jcfg).decls, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    V = jcfg.vocab_size
    return {"arch": arch, "smoke": True, "num_layers": LAYERS,
            "mesh": sizes, "steps": 2, "overrides": overrides,
            "params": jax.tree.map(np.asarray, jp),
            "tokens": rng.integers(0, V, (B, S), dtype=np.int32),
            "targets": rng.integers(0, V, (B, S), dtype=np.int32)}


@pytest.fixture(scope="module")
def tracer():
    with dryrun.CollectiveTracer() as t:
        yield t


def _hold_to_unsharded(arch, sizes, tracer, **overrides):
    torch.set_num_threads(1)
    spec = _spec(arch, sizes, overrides)
    ref = sharded_lm_rank(0, "cpu", spec)
    n = sizes[0] * sizes[1]
    outs = spawn_partitions(sharded_lm_rank, n, "gloo", ["cpu"] * n,
                            args=(spec,), timeout=600)
    cfg = get_config(arch, smoke=True).replace(
        num_layers=LAYERS, param_dtype="float32", compute_dtype="float32",
        **overrides)
    want = dryrun.count_collectives(
        cfg, ShapeConfig("x", "train", S, B),
        AbstractMesh(sizes, ("data", "model")), tracer)
    for r, out in enumerate(outs):
        assert abs(out["loss"] - ref["loss"]) <= ATOL, r
        for k, g in ref["grads"].items():
            err = float((out["grads"][k] - g).abs().max())
            assert err <= ATOL, (r, k, err)
        for k, p in ref["params"].items():
            err = float((out["params"][k] - p).abs().max())
            assert err <= PARAM_REL * float(p.abs().max()), (r, k, err)
        assert out["traffic"]["per_op"] == want["per_op"], (r, out["traffic"],
                                                            want)
        assert out["traffic"]["total"] > 0
        assert not {"jax", "repro"} & set(out["modules"])
    assert ref["traffic"]["total"] == 0


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_unsharded(arch, sizes, tracer):
    _hold_to_unsharded(arch, sizes, tracer)


def test_sharded_adafactor_step_matches_unsharded(tracer):
    """Adafactor's factored moments are means over whole dims: its update
    runs on the DTensors (not a rank's shards) and its state is placed by
    its own declarations."""
    _hold_to_unsharded("llama3.2-3b", (2, 2), tracer, optimizer="adafactor")


def test_pure_data_parallel_moves_the_gradients_once(tracer):
    """(8, 1) without FSDP: every gradient all-reduced once (2 x the f32
    parameter bytes) and the replicated metrics' scalars, nothing else."""
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        fsdp_params=False, param_dtype="float32", compute_dtype="float32")
    got = dryrun.count_collectives(cfg, ShapeConfig("x", "train", 256, 64),
                                   AbstractMesh((8, 1), ("data", "model")),
                                   tracer)
    pbytes = sum(t.numel() * 4 for t in leaves(dryrun.abstract_params(
        build(cfg).decls)))
    assert set(got["per_op"]) == {"all-reduce"}
    assert 0 <= got["per_op"]["all-reduce"] - 2 * pbytes < 64


def test_partial_sums_are_reduced_where_they_are_made(tracer):
    """A row-parallel product's partial sum is all-reduced once, where it is
    made, in the compute dtype: never in f32 inside the next norm, nor
    once more for each product that reads the norm (left to DTensor, one
    PyTorch version did both); the global norm reduces once."""
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        num_layers=LAYERS, param_dtype="bfloat16", compute_dtype="bfloat16")
    got = dryrun.count_collectives(cfg, ShapeConfig("x", "train", S, B),
                                   AbstractMesh((1, 2), ("data", "model")),
                                   tracer, sites=True)
    acts = [s for s in got["sites"] if s["shape"] == [B, S, cfg.d_model]]
    assert acts and {s["dtype"] for s in acts} == {"bfloat16"}
    forward = [s["at"][-1] for s in acts
               if not any("compute_grads" in a for a in s["at"])]
    assert forward and all(a.endswith(("_proj_sharded", "constrain"))
                           for a in forward), forward
    norms = [s for s in got["sites"] if s["shape"] == []
             and any("global_norm" in a for a in s["at"])]
    assert len(norms) == 1
    assert sum(s["bytes"] for s in got["sites"]) == got["total"]


@pytest.mark.parametrize("case", ["late", "failed", "never"])
def test_when_written_waits_for_the_callers_file(tmp_path, case):
    """A rank reads a reference the caller writes beside it: the file once
    it is there, the caller's ``.failed`` note as an error, and a timeout
    where neither comes."""
    import threading

    from repro_torch.launch.group import when_written
    path = tmp_path / "ref0.pt"
    if case == "late":
        def write():
            # as the callers write: a sibling file renamed into place whole
            tmp = path.with_name(path.name + ".tmp")
            tmp.write_bytes(b"x")
            os.replace(tmp, path)
        threading.Timer(0.3, write).start()
        assert when_written(path, timeout=30) == path
        assert path.read_bytes() == b"x"
    elif case == "failed":
        note = path.with_name(path.name + ".failed")
        threading.Timer(0.3, note.write_text, args=("ValueError: x",)).start()
        with pytest.raises(RuntimeError, match="ValueError: x"):
            when_written(path, timeout=30)
    else:
        with pytest.raises(TimeoutError):
            when_written(path, timeout=0.3)
