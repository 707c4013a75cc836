"""The sharded train step of the SSM, hybrid, encoder-decoder and VLM
families (``torch.distributed.tensor`` DTensors on a (data, model) mesh)
against the unsharded port step and against the dry-run's collective
count, as ``tests/test_torch_sharded_step.py`` holds the dense and MoE
ones.

  * ``launch.group.sharded_lm_rank`` over 4 ``gloo`` CPU ranks as (2, 2),
    (4, 1) and (1, 4) (one spawn running the three in turn), and over 2
    as (1, 2), for mamba2-1.3b and zamba2-7b (one shared-attention
    application) here, whisper-medium (2 encoder and 2 decoder layers)
    and qwen2-vl-2b in ``tests/test_torch_sharded_encdec_vlm.py``, at
    smoke size, f32, from JAX's
    converted weights, the frontends (``audio_embeds``; ``vision_embeds``
    and M-RoPE ``positions`` (3, B, S)) from a numpy seed, each batch key
    placed by its own spec: the loss and every gradient within 1e-5 abs
    of the unsharded step run under ``shard_ctx`` of an ``AbstractMesh``
    of the same shape, the parameters after 2 AdamW steps within 1e-4 of
    each leaf's largest magnitude, and each rank's bytes by op equal to
    ``launch.dryrun.count_collectives`` of the same config, shape and
    mesh.  The smoke mamba2's ``in_proj`` output (296 wide) does not
    divide by 4, so (1, 4) keeps it replicated on ``model``.  Whisper's
    weights are JAX's re-scaled by ``init: "fan_in"`` (each projection
    N(0, 1 / its whole fan-in)): from JAX's init as it is, 1e-7 relative
    noise on the audio embeddings moves the unsharded step's own
    gradients by 2.1e-3 (``encoder/ln1/scale``), and the fan-in weights
    by 1.9e-8.
  * Pure data parallelism ((8, 1), ``fsdp_params=False``, B 64, S 256;
    S 128 for whisper, whose decoder position table is 128 rows): all
    all-reduce, within 64 B of twice the f32 parameter bytes.
  * FSDP moves no activation ((8, 1), FSDP on): the all-reduce at most
    twice the f32 bytes of the leaves not sharded on ``data``, plus 64 B,
    and the total at most the same step's without FSDP.
"""
from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import physical_specs
from repro_torch.launch import dryrun
from repro_torch.launch.group import (sharded_lm_rank, sharded_runs_rank,
                                      spawn_partitions)
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.api import VISION_PREFIX, build
from repro_torch.models.params import leaves

ATOL = 1e-5                # loss and gradients, f32
PARAM_REL = 1e-4           # parameters after 2 AdamW steps, of a leaf's max
B, S, LAYERS = 8, 64, 2
MESHES = [(2, 2), (4, 1), (1, 4), (1, 2)]
ARCHS = ["mamba2-1.3b", "zamba2-7b", "whisper-medium", "qwen2-vl-2b"]
# whisper's decoder positions are a 128-row table at smoke size
DP_SHAPE = {"whisper-medium": (64, 128)}
# JAX's init makes the smoke whisper stack chaotic (see above)
TAME = {"whisper-medium": {"init": "fan_in"}}


def vlm_positions(B: int, S: int, vp: int) -> np.ndarray:
    """(3, B, S) int32: the vision prefix as a side x side grid at t = 0,
    the text after it on all three streams from side on."""
    side = int(round(vp ** 0.5))
    i = np.arange(S)
    t = np.where(i < vp, 0, i - vp + side)
    h = np.where(i < vp, i // side, i - vp + side)
    w = np.where(i < vp, i % side, i - vp + side)
    return np.broadcast_to(np.stack([t, h, w])[:, None, :],
                           (3, B, S)).astype(np.int32).copy()


def family_spec(arch, sizes, seed=0, batch=B, seq=S, **kw):
    """A ``sharded_lm_rank`` spec: JAX's smoke weights at LAYERS, the
    ``batch`` x ``seq`` tokens and the family's frontends from a numpy
    seed."""
    B, S = batch, seq
    jcfg = jx_get_config(arch, smoke=True).replace(
        num_layers=LAYERS, param_dtype="float32", compute_dtype="float32")
    jp = jx_init(jx_build(jcfg).decls, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    V, D = jcfg.vocab_size, jcfg.d_model
    spec = {"arch": arch, "smoke": True, "num_layers": LAYERS,
            "mesh": sizes, "steps": 2, "seed": seed,
            "params": jax.tree.map(np.asarray, jp),
            "tokens": rng.integers(0, V, (B, S), dtype=np.int32),
            "targets": rng.integers(0, V, (B, S), dtype=np.int32),
            **TAME.get(arch, {}), **kw}
    if jcfg.family == "encdec":
        spec["audio_embeds"] = rng.normal(
            0, 1, (B, jcfg.encoder_seq, D)).astype(np.float32)
    if jcfg.family == "vlm":
        vp = min(VISION_PREFIX, S // 4)
        spec["vision_embeds"] = rng.normal(0, 1, (B, vp, D)).astype(
            np.float32)
        spec["positions"] = vlm_positions(B, S, vp)
    return spec


def smoke_cfg(arch, **kw):
    return get_config(arch, smoke=True).replace(
        num_layers=LAYERS, param_dtype="float32", compute_dtype="float32",
        **kw)


@pytest.fixture(scope="module")
def tracer():
    with dryrun.CollectiveTracer() as t:
        yield t


_RANKS: dict = {}


def group_results(fn, arch, sizes, meshes, **kw):
    """Each rank's result of ``fn`` (a rank function taking a spec) at
    ``sizes``: the specs of every mesh in ``meshes`` with as many ranks run
    in turn by one spawn (``sharded_runs_rank``), cached for the module's
    other cases."""
    n = sizes[0] * sizes[1]
    key = (fn.__name__, arch, n, tuple(sorted(kw.items())))
    if key not in _RANKS:
        torch.set_num_threads(1)
        same = [m for m in meshes if m[0] * m[1] == n]
        outs = spawn_partitions(
            sharded_runs_rank, n, "gloo", ["cpu"] * n,
            args=([family_spec(arch, m, **kw) for m in same], fn),
            timeout=600)
        _RANKS[key] = {m: [o[i] for o in outs] for i, m in enumerate(same)}
    return _RANKS[key][tuple(sizes)]


def _hold_to_unsharded(arch, sizes, tracer, batch=B, seq=S, params=True,
                       meshes=MESHES):
    torch.set_num_threads(1)
    spec = family_spec(arch, sizes, batch=batch, seq=seq)
    ref = sharded_lm_rank(0, "cpu", spec)
    outs = group_results(sharded_lm_rank, arch, sizes, meshes, batch=batch,
                         seq=seq)
    want = dryrun.count_collectives(
        smoke_cfg(arch), ShapeConfig("x", "train", seq, batch),
        AbstractMesh(sizes, ("data", "model")), tracer)
    for r, out in enumerate(outs):
        assert abs(out["loss"] - ref["loss"]) <= ATOL, r
        for k, g in ref["grads"].items():
            err = float((out["grads"][k] - g).abs().max())
            assert err <= ATOL, (r, k, err)
        for k, p in (ref["params"] if params else {}).items():
            err = float((out["params"][k] - p).abs().max())
            assert err <= PARAM_REL * float(p.abs().max()), (r, k, err)
        assert out["traffic"]["per_op"] == want["per_op"], (r, out["traffic"],
                                                            want)
        assert out["traffic"]["total"] > 0
        assert not {"jax", "repro"} & set(out["modules"])
    assert ref["traffic"]["total"] == 0
    return want


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_sharded_family_step_matches_unsharded(arch, sizes, tracer):
    _hold_to_unsharded(arch, sizes, tracer)


@pytest.mark.parametrize("sizes", [(1, 2), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_sharded_ssm_step_with_few_tokens(arch, sizes, tracer):
    """2 x 16 tokens: a rank's batch rows hold fewer tokens than
    ``in_proj`` has rows (64), and the block still gathers the weight over
    ``model``.  Loss, gradients and bytes are
    held; the parameters after the AdamW steps are not: AdamW's step is
    about lr x sign(g) wherever |g| is well above its eps, and at so few
    tokens zamba2's ``in_proj`` has gradients of 1e-7 whose sign the f32
    noise of the partial sums (5e-6 at a largest gradient of 0.77)
    flips, one lr apart in the parameter."""
    _hold_to_unsharded(arch, sizes, tracer, batch=2, seq=16, params=False,
                       meshes=[(1, 2), (2, 2)])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_ssm_block_gathers_the_smaller_operand(arch, tracer):
    """At (1, 2) the ``in_proj`` (64, 296) is sharded on ``model``.  The
    block gathers the weight (the collective's result: the two (64, 148)
    shards stacked) and never the product's output (two (b, s, 148)
    shards), whether the weight is the smaller operand (8 x 64 tokens) or
    not (2 x 16): one route, the one every production cell takes."""
    cfg = smoke_cfg(arch)
    mesh = AbstractMesh((1, 2), ("data", "model"))
    E = dryrun.build(cfg).decls["layers" if arch.startswith("mamba")
                                else "mamba"]["block"]["in_proj"].shape[-1]
    weight = [2 * cfg.d_model, E // 2]
    for b, s in ((B, S), (2, 16)):
        got = dryrun.count_collectives(cfg, ShapeConfig("x", "train", s, b),
                                       mesh, tracer, sites=True)
        shapes = [x["shape"] for x in got["sites"]
                  if x["op"] == "all-gather"]
        assert weight in shapes, shapes
        assert [2 * b, s, E // 2] not in shapes, shapes


def _pure_dp(arch, fsdp, tracer):
    Bd, Sd = DP_SHAPE.get(arch, (64, 256))
    cfg = smoke_cfg(arch, fsdp_params=fsdp)
    mesh = AbstractMesh((8, 1), ("data", "model"))
    got = dryrun.count_collectives(cfg, ShapeConfig("x", "train", Sd, Bd),
                                   mesh, tracer)
    return cfg, mesh, got


@pytest.mark.parametrize("arch", ARCHS)
def test_pure_data_parallel_moves_the_gradients_once(arch, tracer):
    cfg, _, got = _pure_dp(arch, False, tracer)
    pbytes = sum(t.numel() * 4 for t in leaves(dryrun.abstract_params(
        build(cfg).decls)))
    assert set(got["per_op"]) == {"all-reduce"}, got["per_op"]
    assert 0 <= got["per_op"]["all-reduce"] - 2 * pbytes < 64


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_moves_no_activation(arch, tracer):
    cfg, mesh, got = _pure_dp(arch, True, tracer)
    decls = build(cfg).decls
    replicated = sum(math.prod(d.shape) * 4 for d, s in zip(
        leaves(decls), leaves(physical_specs(decls, cfg, mesh)))
        if "data" not in [a for ax in s for a in
                          (ax if isinstance(ax, tuple) else (ax,))])
    assert got["per_op"].get("all-reduce", 0) <= 2 * replicated + 64, \
        (got["per_op"], replicated)
    assert got["total"] <= _pure_dp(arch, False, tracer)[2]["total"]
