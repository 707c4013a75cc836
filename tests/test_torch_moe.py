"""The port's MoE LMs against the JAX package's: ``moe_mlp`` alone (with
and without dropped tokens), the MoE model's block prefill and decode step
and the continuous-batching engine, on the smoke configs of
qwen2-moe-a2.7b (pad experts, 4 shared experts) and kimi-k2-1t-a32b (GQA,
one shared expert).  Parameters come from JAX's ``init_params`` and are
carried across by ``models/convert.py``; inputs come from a numpy seed.

Tolerances: at ``compute_dtype="float32"`` outputs, logits and caches
within atol = rtol = 1e-4 (``tests/test_torch_lm.py``'s: the two
frameworks' CPU matmuls sum in different orders); the routing (each
token's experts and each expert's gathered tokens) equal; greedy token
streams identical.  At bf16 the top-k expert indices must equal JAX's,
which holds the router in f32 in the port's compute copy, and the layer's
output JAX's within atol = rtol = 2e-2 (a few bf16 ulps).  ``combine``,
the sum back over experts, is JAX's scatter-add bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro.serve.engine import Engine as JxEngine
from repro.serve.engine import Request as JxRequest
from repro_torch.configs import get_config
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.api import build, compute_params
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import init_params, leaves, tree_map
from repro_torch.serve.engine import Engine, Request

ARCHS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]
F32 = dict(atol=1e-4, rtol=1e-4)


def _cfgs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (jx_get_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _params(jcfg, seed=0):
    jp = jx_init(jx_build(jcfg).decls, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            tree_map(lambda a: a[0], tp["layers"]["moe"]))


def _x(cfg, B, S, seed=2):
    return np.random.default_rng(seed).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _jx_routing(p, x, cfg):
    """Each token's top-k experts and each expert's gathered tokens, as
    JAX's ``moe_mlp`` computes them (DS = 1)."""
    T_ = x.shape[0] * x.shape[1]
    E, K = cfg.num_experts_padded, cfg.moe_top_k
    logits = jnp.asarray(x).reshape(T_, -1) @ p["router"]
    logits = jnp.where(jnp.arange(E) < cfg.num_experts, logits, -1e30)
    topw, topi = jax.lax.top_k(jax.nn.softmax(logits, -1), K)
    topw = topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9)
    w_te = jnp.einsum("tke,tk->te", jax.nn.one_hot(topi, E), topw)
    gw, idx = jax.lax.top_k(jnp.where(w_te > 0, w_te, -jnp.inf).T,
                            JM.capacity(cfg, T_))
    return np.asarray(topi), np.asarray(idx), np.isfinite(np.asarray(gw))


@pytest.mark.parametrize("arch", ARCHS)
def test_decls_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jd = jax.tree.map(lambda d: d.shape, jx_build(jcfg).decls,
                      is_leaf=lambda d: hasattr(d, "axes"))
    assert tree_map(lambda d: d.shape, build(cfg).decls) == jd


@pytest.mark.parametrize("T_", [1, 7, 64, 1000])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch, T_):
    jcfg, cfg = _cfgs(arch)
    assert M.capacity(cfg, T_) == JM.capacity(jcfg, T_)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [1.25, 0.3], ids=["capacity", "dropping"])
def test_moe_mlp_matches_jax(arch, cf):
    jcfg, cfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _params(jcfg)
    jm, tm = _layer0(jp, tp)
    x = _x(cfg, 2, 40)
    _, _, valid = _jx_routing(jm, x, jcfg)
    if cf < 1:      # capacity 8 of 80 tokens: routed tokens are dropped
        assert valid.sum() < x.shape[0] * x.shape[1] * cfg.moe_top_k
    jy, jaux = JM.moe_mlp(jm, jnp.asarray(x), jcfg)
    ty, taux = M.moe_mlp(tm, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)


def _routing(seed, E=8, C=5, T=20, K=3):
    """A routing as ``moe_mlp`` makes one: each token's K experts, each
    expert's C slots (its routed tokens first, shuffled, cut at C; then
    distinct unrouted tokens, invalid), and the slots' outputs (zeros where
    invalid)."""
    rng = np.random.default_rng(seed)
    topi = np.stack([rng.permutation(E)[:K] for _ in range(T)])
    idx = np.zeros((E, C), np.int64)
    valid = np.zeros((E, C), bool)
    for e in range(E):
        toks = rng.permutation(np.flatnonzero((topi == e).any(1)))[:C]
        rest = np.setdiff1d(np.arange(T), toks)[:C - len(toks)]
        idx[e] = np.concatenate([toks, rest])
        valid[e, :len(toks)] = True
    out = rng.normal(0, 1, (E, C, 16)).astype(np.float32) * valid[..., None]
    return topi, idx, valid, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(6))
def test_combine_is_jax_scatter_add_bit_for_bit(seed, dtype):
    # the order contract: a token's contributions added in ascending expert
    # order, rounded to the output's dtype at each add, as JAX's scatter
    # over the expert-major slots adds them; a gather, no atomics
    topi, idx, valid, out = _routing(seed)
    E, C, D = out.shape
    jo = jnp.asarray(out).astype(dtype)
    want = jnp.zeros((topi.shape[0], D), dtype).at[idx.reshape(-1)].add(
        jo.reshape(E * C, D), mode="drop")
    to = torch.from_numpy(out).to(getattr(torch, dtype))
    got = M.combine(to, torch.from_numpy(idx), torch.from_numpy(valid),
                    torch.from_numpy(topi))
    assert got.dtype == to.dtype
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    toks = _tokens(cfg, 2, 32)
    jl, jc = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = build(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    B, Tlen = 3, 8
    jcache = jx_init(JT.cache_decls(jcfg, B, Tlen), jax.random.PRNGKey(0))
    tcache = init_params(T.cache_decls(cfg, B, Tlen), torch.Generator(), "cpu")
    toks = _tokens(cfg, 4, B, seed=3)
    for step, pos in enumerate(([0, 0, 5], [1, 0, 6], [2, 1, 7], [3, 2, 7])):
        batch = {"token": toks[step], "pos": np.array(pos, np.int32)}
        jl, jcache = JT.decode_step(jp, jcache, jax.tree.map(jnp.asarray,
                                                             batch), jcfg)
        tl, tcache = T.decode_step(tp, tcache, {k: torch.from_numpy(v) for
                                                k, v in batch.items()}, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_routing_matches_jax(arch):
    # JAX reads the router in f32 from the f32 master at every use; the
    # port's compute copy keeps it so, and the experts chosen are JAX's
    jcfg, cfg = _cfgs(arch, compute_dtype="bfloat16")
    jp, tp = _params(jcfg)
    jm, _ = _layer0(jp, tp)
    tm = compute_params(tp, cfg)["layers"]["moe"]
    assert tm["router"].dtype == torch.float32
    assert tm["w_gate"].dtype == torch.bfloat16
    x = jnp.asarray(_x(cfg, 2, 24)).astype(jnp.bfloat16)
    want, _, _ = _jx_routing(jm, x.astype(jnp.float32), jcfg)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    logits = xt.reshape(48, -1).float() @ tm["router"][0]
    logits[:, cfg.num_experts:] = M.PAD_LOGIT
    got = torch.topk(torch.softmax(logits, -1), cfg.moe_top_k, -1).indices
    assert np.array_equal(got.numpy(), want)
    # and the layer's output is JAX's to a few bf16 ulps (2^-8 relative
    # each; the frameworks round the products in different places)
    jy, _ = JM.moe_mlp(jm, x, jcfg)
    ty, _ = M.moe_mlp(tree_map(lambda a: a[0], tm), xt, cfg)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), atol=2e-2,
                               rtol=2e-2)


def _requests(cfg, cls, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                           int(rng.integers(2, 9))
                                           ).astype(np.int32),
                max_new_tokens=5) for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    # the decode step routes every slot's token with capacity >= the batch,
    # so no token is dropped and the streams hold the model alone; this is
    # the engine's check for MoE (the block prefill drops past capacity, so
    # its argmax is no oracle for the first token)
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    je = JxEngine(jcfg, params=jp, batch=3, max_len=48, seed=0)
    te = Engine(cfg, params=tp, batch=3, max_len=48, seed=0, device="cpu")
    for eng, cls in ((je, JxRequest), (te, Request)):
        for r in _requests(cfg, cls):
            eng.submit(r)
    js, ts = je.run_to_completion(), te.run_to_completion()
    assert ts["completed"] == js["completed"] == 6
    got = {r.rid: r.out_tokens for r in te.completed}
    assert got == {r.rid: r.out_tokens for r in je.completed}


def test_init_params_dtype_override():
    _, cfg = _cfgs("qwen2-moe-a2.7b")
    decls = build(cfg).decls
    p32 = init_params(decls, torch.Generator().manual_seed(0), "cpu")
    p16 = init_params(decls, torch.Generator().manual_seed(0), "cpu",
                      dtype_override=torch.bfloat16)
    for a, b in zip(leaves(p32), leaves(p16)):
        assert b.dtype == torch.bfloat16 and torch.equal(a.bfloat16(), b)
    # a tree drawn in the compute dtype is served as it is: nothing copied
    cp = compute_params(p16, cfg.replace(compute_dtype="bfloat16"))
    assert cp["layers"]["moe"]["w_gate"] is p16["layers"]["moe"]["w_gate"]
