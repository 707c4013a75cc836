"""The port's hybrid LM (``models/hybrid.py``: Mamba2 layers and one shared
attention block) against the JAX package's on the zamba2-7b smoke config
(5 Mamba2 layers, the shared block after layers 2 and 4, none after the
fifth): the grouping, the declarations, the block prefill, the decode
step and the engine.  Parameters come from JAX's ``init_params`` (carried
across by ``models/convert.py``); inputs from a numpy seed.

Tolerances: at ``compute_dtype="float32"`` logits and every cache within
atol = rtol = 1e-4 (``tests/test_torch_lm.py``'s); greedy streams
identical, with a slot that a second request reuses (its SSM and conv
state are not reset, in either package)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models import hybrid as JH
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro.serve.engine import Engine as JxEngine
from repro.serve.engine import Request as JxRequest
from repro_torch.configs import get_config
from repro_torch.models import hybrid as H
from repro_torch.models.api import build
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import init_params, tree_map
from repro_torch.serve.engine import Engine, Request

ARCH = "zamba2-7b"
F32 = dict(atol=1e-4, rtol=1e-4)
CACHES = ("ssm", "conv", "k", "v")


def _cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return (jx_get_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


def _params(jcfg, seed=0):
    """JAX's initial parameters, with A_log and dt_bias (zeros at init)
    drawn from a seed so every layer's decays differ."""
    jp = jax.tree.map(np.array, jx_init(jx_build(jcfg).decls,
                                        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 7)
    blk = jp["mamba"]["block"]
    blk["A_log"] = rng.uniform(-1, 1, blk["A_log"].shape).astype(np.float32)
    blk["dt_bias"] = rng.uniform(-2, 0.5, blk["dt_bias"].shape
                                 ).astype(np.float32)
    return jax.tree.map(jnp.asarray, jp), params_from_jax(jp, "cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("layers,every", [(5, 2), (81, 6), (6, 6), (3, 6)])
def test_groups_match_jax(layers, every):
    jcfg, cfg = _cfgs(num_layers=layers, shared_attn_every=every)
    assert H._groups(cfg) == JH._groups(jcfg)
    assert H.n_attn_blocks(cfg) == JH.n_attn_blocks(jcfg)


def test_decls_match_jax():
    jcfg, cfg = _cfgs()
    jd = jax.tree.map(lambda d: d.shape, jx_build(jcfg).decls,
                      is_leaf=lambda d: hasattr(d, "axes"))
    assert tree_map(lambda d: d.shape, build(cfg).decls) == jd
    jc = jax.tree.map(lambda d: (d.shape, jnp.dtype(d.dtype).name),
                      JH.cache_decls(jcfg, 3, 16),
                      is_leaf=lambda d: hasattr(d, "axes"))
    tc = tree_map(lambda d: (d.shape, str(d.dtype).replace("torch.", "")),
                  H.cache_decls(cfg, 3, 16))
    assert tc == jc


@pytest.mark.parametrize("S", [12, 64])
def test_prefill_matches_jax(S):
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    toks = _tokens(cfg, 2, S)
    jl, jc = JH.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = build(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    for name in CACHES:
        assert tuple(tc[name].shape) == jc[name].shape
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **F32)


def test_decode_step_matches_jax():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    B, Tlen = 3, 8
    jcache = jx_init(JH.cache_decls(jcfg, B, Tlen), jax.random.PRNGKey(0))
    tcache = init_params(H.cache_decls(cfg, B, Tlen), torch.Generator(), "cpu")
    toks = _tokens(cfg, 4, B, seed=3)
    # slot 2 runs past the cache at the last step: JAX drops that write
    for step, pos in enumerate(([0, 0, 5], [1, 0, 6], [2, 1, 7], [3, 2, 8])):
        batch = {"token": toks[step], "pos": np.array(pos, np.int32)}
        jl, jcache = JH.decode_step(jp, jcache, jax.tree.map(jnp.asarray,
                                                             batch), jcfg)
        tl, tcache = build(cfg).decode(tp, tcache, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        for name in CACHES:
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), **F32)


@pytest.mark.parametrize("batch,prompts", [
    (2, None), (1, "same_twice")], ids=["continuous", "slot_reused"])
def test_engine_matches_jax_engine(batch, prompts):
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(0)
    if prompts is None:
        ps = [rng.integers(1, cfg.vocab_size, int(rng.integers(2, 9))
                           ).astype(np.int32) for _ in range(5)]
    else:
        ps = [np.array([5, 9, 3, 7, 11, 2], np.int32)] * 2
    je = JxEngine(jcfg, params=jp, batch=batch, max_len=48, seed=0)
    te = Engine(cfg, params=tp, batch=batch, max_len=48, seed=0, device="cpu")
    for eng, cls in ((je, JxRequest), (te, Request)):
        for rid, pr in enumerate(ps):
            eng.submit(cls(rid=rid, prompt=pr, max_new_tokens=6))
    js, ts = je.run_to_completion(), te.run_to_completion()
    assert ts["completed"] == js["completed"] == len(ps)
    got = {r.rid: r.out_tokens for r in te.completed}
    assert got == {r.rid: r.out_tokens for r in je.completed}


def test_engine_first_token_is_prefill_argmax():
    # the sequential recurrence and decode attention against the chunked
    # SSD and the block prefill's attention
    _, cfg = _cfgs()
    eng = Engine(cfg, batch=1, max_len=32, seed=0, device="cpu")
    prompt = np.array([5, 9, 3, 7, 11, 2, 40, 8], np.int32)
    logits, _ = eng.model.prefill(eng.params,
                                  {"tokens": torch.from_numpy(prompt)[None]})
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=1))
    eng.run_to_completion()
    assert eng.completed[0].out_tokens[0] == int(logits[0].argmax())
