"""Every LM family's prefill writes its caches into one buffer allocated
before its layer loop (``layers.prefill_caches`` / ``write_layer``), as
JAX's layer scan writes its stacked output, where it once kept a list of
per-layer tensors and stacked it at the end.

For llama3.2-3b, qwen2-moe-a2.7b, qwen2-vl-2b, mamba2-1.3b, zamba2-7b and
whisper-medium at smoke size:

  * (a) the logits and every cache are bit-equal to the stacked form (the
    list-then-stack loops, kept below as the witness), in f32 and in
    bf16; and held to JAX's ``repro.models.api.build(cfg).prefill`` on
    the same numpy inputs, weights carried over by ``models/convert.py``,
    within the family tests' tolerances: f32 within 1e-5 of each output's
    largest magnitude, on weights drawn tame (each projection N(0, 1 /
    its whole fan-in), as the sharded tests draw them), bf16 logits
    within atol 0.25 and each layer of each cache within 5% of the
    cache's largest entry (``tests/test_torch_lm.py``: the port keeps
    attention scores in f32 where JAX rounds them to bf16);
  * (b) the prefill's memory traced on ``meta`` (``LiveBytes``, through
    ``launch.dryrun.trace_unsharded``) at a width whose caches outweigh a
    layer's activations: from depth L to 2L the peak above the arguments
    rises by the buffer's growth (each cache's allocator block at 2L less
    its block at L: L layers of cache) within one layer's cache bytes;
    the stacked form, traced the same way, rises by at least 2L layers
    less that tolerance;
  * (c) over 4 ``gloo`` CPU ranks as (2, 2) (one spawn for the six), the
    sharded prefill as the dry-run traces it
    (``launch.group.sharded_serve_rank``): its caches equal the
    unsharded ones (within 1e-5 of each cache's largest magnitude, at
    least 1; the logits within 1e-5), each carries the placements its
    declaration gives, and each rank's collective bytes by op equal
    ``launch.dryrun.count_collectives`` of the same cell.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import (constrain, make_rules,
                                              physical_specs, placements)
from repro_torch.launch import dryrun
from repro_torch.launch.group import (lm_setup, sharded_runs_rank,
                                      sharded_serve_rank, spawn_partitions)
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import api as A
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.api import build, compute_params
from repro_torch.models.convert import params_from_jax, params_to_numpy
from test_torch_sharded_families import family_spec, smoke_cfg
from test_torch_vlm import grid_positions

ARCHS = ["llama3.2-3b", "qwen2-moe-a2.7b", "qwen2-vl-2b", "mamba2-1.3b",
         "zamba2-7b", "whisper-medium"]
DTYPES = ["float32", "bfloat16"]
B, S = 2, 24
F32_REL = 1e-5
BF16_LOGITS_ATOL = 0.25
BF16_CACHE_REL = 0.05
MiB = 2**20


# ---------------------------------------------------------------------------
# The witness: the prefills as they were, each layer's caches kept in a list
# and stacked once the loop ends
# ---------------------------------------------------------------------------

def _stacked_transformer(params, batch, cfg):
    h = T._embed_input(params, batch, cfg)
    Bh, Sh, _ = h.shape
    positions = T._positions(batch, cfg, Bh, Sh, h.device)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = T._layer(params, i)
        a, (k, v) = L.attention_prefill(
            lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg, positions)
        h = constrain(T._mlp_residual(lp, h + a, cfg), "dp", None, None)
        ks.append(k)
        vs.append(v)
    return T._logits(params, h[:, -1], cfg), {"k": torch.stack(ks),
                                              "v": torch.stack(vs)}


def _stacked_hybrid(params, batch, cfg):
    h = constrain(L.embed(params["embed"], batch["tokens"], cfg,
                          T._cdt(cfg)), "dp", None, None)
    Bh, Ssz, _ = h.shape
    positions = torch.arange(Ssz, dtype=torch.int32,
                             device=h.device)[None].expand(Bh, Ssz)
    ssms, convs, ks, vs = [], [], [], []
    for (start, size, has_attn) in HY._groups(cfg):
        for i in range(start, start + size):
            h, fstate, tail = SSM.mamba2_residual_prefill(
                T._layer(params, i, "mamba"), h, cfg)
            ssms.append(fstate)
            convs.append(tail)
        if has_attn:
            sp = params["shared"]
            a, (k, v) = L.attention_prefill(
                sp["attn"], L.rmsnorm(sp["ln1"], h, cfg.norm_eps), cfg,
                positions)
            h = HY._shared_mlp(sp, h + a, cfg)
            ks.append(k)
            vs.append(v)
    caches = {"ssm": torch.stack(ssms), "conv": torch.stack(convs),
              "k": torch.stack(ks), "v": torch.stack(vs)}
    return T._logits(params, h[:, -1], cfg), caches


def _stacked_ssm(params, batch, cfg):
    h = constrain(L.embed(params["embed"], batch["tokens"], cfg,
                          T._cdt(cfg)), "dp", None, None)
    fstates, tails = [], []
    for i in range(cfg.num_layers):
        h, fstate, tail = SSM.mamba2_residual_prefill(T._layer(params, i), h,
                                                      cfg)
        fstates.append(fstate)
        tails.append(tail)
    return T._logits(params, h[:, -1], cfg), {"ssm": torch.stack(fstates),
                                              "conv": torch.stack(tails)}


def _stacked_encdec(params, batch, cfg):
    enc_out = ED.encode(params, batch["audio_embeds"], cfg)
    h = ED._embed_dec(params, batch["tokens"], cfg)
    caches = {"k": [], "v": [], "xk": [], "xv": []}
    for i in range(cfg.num_layers):
        lp = T._layer(params, i, "decoder")
        a, (k, v) = L.attention_prefill(lp["attn"], ED._ln(lp["ln1"], h, cfg),
                                        cfg, causal=True)
        xk, xv = L.cross_kv(lp["xattn"], enc_out, cfg)
        h = ED._cross_residual(lp, h + a, (xk, xv), cfg)
        h = constrain(ED._mlp_residual(lp, h, cfg), "dp", None, None)
        for name, t in zip(caches, (k, v, xk, xv)):
            caches[name].append(t)
    return (ED._logits(params, h[:, -1], cfg),
            {name: torch.stack(ts) for name, ts in caches.items()})


# where each family's Model reads its prefill at call time
STACKED = {"dense": (T, "prefill", _stacked_transformer),
           "moe": (T, "prefill", _stacked_transformer),
           "vlm": (T, "prefill", _stacked_transformer),
           "hybrid": (HY, "prefill", _stacked_hybrid),
           "ssm": (A, "_ssm_prefill", _stacked_ssm),
           "encdec": (ED, "prefill", _stacked_encdec)}


def _stacked(params, batch, cfg):
    return STACKED[cfg.family][2](params, batch, cfg)


# ---------------------------------------------------------------------------
# Inputs and weights
# ---------------------------------------------------------------------------

def _cfgs(arch, dtype):
    return (jx_get_config(arch, smoke=True).replace(compute_dtype=dtype),
            get_config(arch, smoke=True).replace(compute_dtype=dtype))


def _weights(arch, jcfg, seed=0):
    """Numpy weights of ``jcfg``: JAX's ``init_params`` redrawn tame as
    the sharded tests draw them (``launch.group.lm_setup``'s ``init:
    "fan_in"``: each projection N(0, 1 / its whole fan-in)); from JAX's
    init as it is, the smoke zamba2 and whisper stacks amplify f32
    rounding past 1e-5 (``tests/test_torch_sharded_serve.py``)."""
    tree = jax.tree.map(np.asarray, jx_init(jx_build(jcfg).decls,
                                            jax.random.PRNGKey(seed)))
    _, _, params, _ = lm_setup({"arch": arch, "smoke": True,
                                "num_layers": jcfg.num_layers, "seed": seed,
                                "batch": B, "seq": S,
                                "params": tree, "init": "fan_in"}, "cpu")
    return params_to_numpy(params)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if cfg.family == "encdec":
        batch["audio_embeds"] = rng.normal(
            0, 1, (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        vp, side = 16, 4
        batch["vision_embeds"] = rng.normal(0, 1, (B, vp, cfg.d_model)
                                            ).astype(np.float32)
        batch["positions"] = grid_positions(B, S, vp, side)
    return batch


def _port(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype)
    tree = _weights(arch, jcfg)
    params = params_from_jax(tree, "cpu")
    if dtype == "bfloat16":
        params = compute_params(params, cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    return jcfg, cfg, tree, params, batch


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_is_bit_equal_to_the_stacked_form(arch, dtype):
    _, cfg, _, params, batch = _port(arch, dtype)
    with torch.no_grad():
        logits, caches = build(cfg).prefill(params, batch)
        want_logits, want = _stacked(params, batch, cfg)
    assert torch.equal(logits, want_logits)
    assert set(caches) == set(want)
    decls = build(cfg).cache_decls(B, S)
    for name, c in caches.items():
        assert c.dtype == want[name].dtype == decls[name].dtype, name
        assert c.shape == want[name].shape == decls[name].shape, name
        assert torch.equal(c, want[name]), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, dtype):
    jcfg, cfg, tree, params, batch = _port(arch, dtype)
    jp = jax.tree.map(jnp.asarray, tree)     # JAX casts at each use
    jl, jc = jx_build(jcfg).prefill(
        jp, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    with torch.no_grad():
        tl, tc = build(cfg).prefill(params, batch)
    assert set(tc) == set(jc)
    want_l = np.asarray(jl, np.float32)
    if dtype == "float32":
        _close(tl.numpy(), want_l, F32_REL)
        for name, c in tc.items():
            _close(c.numpy(), np.asarray(jc[name]), F32_REL)
        return
    np.testing.assert_allclose(tl.numpy(), want_l, atol=BF16_LOGITS_ATOL)
    for name, c in tc.items():
        want = np.asarray(jc[name], np.float32)
        got = c.float().numpy()
        assert got.shape == want.shape, name
        top = np.abs(want).max()
        for i in range(got.shape[0]):
            err = np.abs(got[i] - want[i]).max()
            assert err <= BF16_CACHE_REL * top, (name, i, err, top)


def _close(got, want, tol):
    assert got.shape == want.shape
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * top, (err, top)


# ---------------------------------------------------------------------------
# (b) The memory trace: one cache, not two
# ---------------------------------------------------------------------------

# (arch, prompt length, config overrides, depth L in layers or, for the
# hybrid, in shared-attention groups): narrow smoke widths, prompts long
# enough that L layers of cache outweigh a layer's activations (the
# encoder-decoder's position table widened to the prompt; the SSM's state,
# its cache, widened over a short prompt)
RISE_CASES = [("llama3.2-3b", 1024, {}, 16),
              ("qwen2-moe-a2.7b", 1024, {}, 16),
              ("qwen2-vl-2b", 1024, {}, 16),
              ("mamba2-1.3b", 8, {"ssm_state": 128}, 4),
              ("zamba2-7b", 1024, {}, 4),
              ("whisper-medium", 1024, {"max_seq": 1024}, 16)]


def _traced_rise(cfg, shape, stacked, monkeypatch):
    """The prefill's traced peak above its arguments (``LiveBytes`` on
    ``meta``), through the family's own prefill or the stacked witness."""
    if stacked:
        mod, name, fn = STACKED[cfg.family]
        monkeypatch.setattr(mod, name, fn)
    got = dryrun.trace_unsharded(cfg, shape)
    monkeypatch.undo()
    return got["peak_bytes"] - got["entry_bytes"]


@pytest.mark.parametrize("arch,seq,over,depth", RISE_CASES,
                         ids=[c[0] for c in RISE_CASES])
def test_traced_peak_rises_by_one_cache_a_layer(arch, seq, over, depth,
                                                monkeypatch):
    """From depth L to 2L the peak rises by the buffer's growth, each
    cache's block at 2L less its block at L, within one layer's cache
    bytes (the program point of the peak may move by a few activations);
    the stacked form rises by at least 2L layers less that tolerance: the
    list and the stack, live together."""
    from repro_torch.launch.footprint import allocator_block
    base = get_config(arch, smoke=True).replace(**over)
    unit = base.shared_attn_every if base.family == "hybrid" else 1
    shape = ShapeConfig("x", "prefill", seq, 1)
    cfgs = [base.replace(num_layers=n * unit) for n in (depth, 2 * depth)]
    decls = [build(c).cache_decls(1, seq) for c in cfgs]

    def nbytes(d):
        return int(np.prod(d.shape)) * torch.empty(
            (), dtype=d.dtype).element_size()
    layer = sum(nbytes(decls[0][k]) for k in decls[0]) // depth
    growth = sum(allocator_block(nbytes(decls[1][k]))
                 - allocator_block(nbytes(decls[0][k])) for k in decls[0])
    rise = [_traced_rise(c, shape, False, monkeypatch) for c in cfgs]
    stacked = [_traced_rise(c, shape, True, monkeypatch) for c in cfgs]
    assert abs((rise[1] - rise[0]) - growth) <= layer, (rise, growth, layer)
    assert stacked[1] - stacked[0] >= 2 * depth * layer - layer, \
        (stacked, depth * layer)


# ---------------------------------------------------------------------------
# (c) The sharded prefill over 4 gloo ranks
# ---------------------------------------------------------------------------

MESH = (2, 2)
# as tests/test_torch_sharded_serve.py draws them: JAX's init makes the
# smoke zamba2 and whisper stacks amplify f32 rounding past 1e-5
TAME = {"zamba2-7b": {"init": "fan_in"}, "whisper-medium": {"init": "fan_in"}}


class _Mesh:
    """The (data, model) mesh's names and sizes, as ``placements`` reads a
    ``DeviceMesh``."""
    mesh_dim_names = ("data", "model")

    def size(self, i):
        return MESH[i]


# whisper-medium with its caches declared apart from its projections: the
# self caches sharded on the sequence, the cross caches replicated on the
# kv heads, which the K/V projections shard
APART = ("whisper-medium", {"kv_shard": "sequence"})
APART_KEY = "whisper-medium, kv_shard sequence"


@pytest.fixture(scope="module")
def sharded():
    """Each case's (spec, the unsharded reference, each rank's result),
    keyed by arch (and ``APART_KEY``): one spawn of 4 gloo ranks running the
    seven prefills in turn.  This process computes on one thread beside
    the ranks, and gives its thread count back after (a later module's
    host-simulated run in the same worker must sum as its spawned ranks
    do)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases = [(a, {}) for a in ARCHS] + [APART]
        specs = [family_spec(a, MESH, overrides=over, **TAME.get(a, {}))
                 for a, over in cases]
        outs = spawn_partitions(sharded_runs_rank, 4, "gloo", ["cpu"] * 4,
                                args=(specs, sharded_serve_rank),
                                timeout=600)
        return {(APART_KEY if over else a): (
                    spec, sharded_serve_rank(0, "cpu", spec),
                    [o[i] for o in outs])
                for i, ((a, over), spec) in enumerate(zip(cases, specs))}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tracer():
    with dryrun.CollectiveTracer() as t:
        yield t


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_caches_keep_their_declared_placements(
        arch, sharded, tracer):
    _hold_sharded(sharded[arch], smoke_cfg(arch), tracer)


def test_cross_attention_reads_its_projections_placement(sharded, tracer):
    """Where the cross caches are declared replicated on the kv heads and
    the projections shard them, the cross attention reads the layer's own
    K and V (``write_layer`` returns them), not the replicated slots: the
    prefill matches the unsharded one, the caches keep the declared
    placements, and each rank's bytes equal the trace."""
    arch, over = APART
    cfg = smoke_cfg(arch, **over)
    mesh = AbstractMesh(MESH, ("data", "model"))
    specs = physical_specs(build(cfg).cache_decls(B, S), cfg, mesh)
    assert make_rules(cfg, mesh)["tp_kv"] == "model"
    assert [str(p) for p in placements(specs["xk"], _Mesh())] == ["S(1)", "R"]
    _hold_sharded(sharded[APART_KEY], cfg, tracer)


def _hold_sharded(case, cfg, tracer):
    spec, ref, ranks = case
    B, S = spec["tokens"].shape
    mesh = AbstractMesh(MESH, ("data", "model"))
    decls = build(cfg).cache_decls(B, S)
    want = {k: [str(p) for p in placements(s, _Mesh())]
            for k, s in physical_specs(decls, cfg, mesh).items()}
    traced = dryrun.count_collectives(
        cfg, ShapeConfig("x", "prefill", S, B), mesh, tracer)
    assert ref["prefill_placements"] == {}
    assert ref["prefill_traffic"]["total"] == 0
    for r, out in enumerate(ranks):
        assert out["prefill_placements"] == want, \
            (r, out["prefill_placements"], want)
        err = float((out["prefill_logits"] - ref["prefill_logits"]).abs()
                    .max())
        assert err <= F32_REL, (r, err)
        assert set(out["prefill_caches"]) == set(ref["prefill_caches"])
        for k, c in ref["prefill_caches"].items():
            err = float((out["prefill_caches"][k] - c).abs().max())
            assert err <= F32_REL * max(1.0, float(c.abs().max())), (r, k,
                                                                     err)
        assert out["prefill_traffic"]["per_op"] == traced["per_op"], \
            (r, out["prefill_traffic"], traced)
        assert not {"jax", "repro"} & set(out["modules"])
