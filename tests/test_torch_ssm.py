"""The port's Mamba2 (``models/ssm.py``) and pure-SSM LM against the JAX
package's: ``_segsum``, ``_causal_conv``, ``ssd_chunked`` (with and
without ``init_state``), ``mamba2_block``, ``mamba2_decode``,
``_ssm_prefill`` / ``_ssm_decode`` and the engine, on the mamba2-1.3b
smoke config; and, as ``tests/test_ssd.py`` holds JAX's, the chunked SSD
against the token-by-token recurrence and the decode step against the
block.  Parameters come from JAX's ``init_params`` (carried across by
``models/convert.py``); inputs from a numpy seed.

Tolerances: atol = rtol = 1e-4 in f32 (``tests/test_torch_lm.py``'s; the
SSD sums the same terms in another order), as ``tests/test_ssd.py`` for
the recurrence; the decode-vs-block check uses that file's atol 2e-4,
rtol 2e-3.  Greedy streams identical, with a slot that a second request
reuses: its SSM and conv state are not reset, in either package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models import api as JA
from repro.models import ssm as JS
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro.serve.engine import Engine as JxEngine
from repro.serve.engine import Request as JxRequest
from repro_torch.configs import get_config
from repro_torch.models import api as A
from repro_torch.models import ssm as S
from repro_torch.models.api import build
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import init_params, tree_map
from repro_torch.serve.engine import Engine, Request

ARCH = "mamba2-1.3b"
F32 = dict(atol=1e-4, rtol=1e-4)


def _cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return (jx_get_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


def _params(jcfg, seed=0):
    jp = jx_init(jx_build(jcfg).decls, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _block(jp, tp, i=0):
    """Layer i's Mamba2 block in both packages; A_log and dt_bias drawn
    from a seed (their init is zeros) so the decays differ per head."""
    jb = jax.tree.map(lambda a: np.array(a[i]), jp["layers"]["block"])
    rng = np.random.default_rng(7 + i)
    nh = jb["A_log"].shape[0]
    jb["A_log"] = rng.uniform(-1.0, 1.0, nh).astype(np.float32)
    jb["dt_bias"] = rng.uniform(-2.0, 0.5, nh).astype(np.float32)
    return jax.tree.map(jnp.asarray, jb), params_from_jax(jb, "cpu")


def _ssd_inputs(Bsz, Ssz, nh, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (Bsz, Ssz, nh, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, (Bsz, Ssz, nh)).astype(np.float32),
            -rng.uniform(0.5, 2.0, nh).astype(np.float32),
            rng.normal(0, 1, (Bsz, Ssz, N)).astype(np.float32),
            rng.normal(0, 1, (Bsz, Ssz, N)).astype(np.float32))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def test_segsum_matches_jax():
    a = np.random.default_rng(0).normal(0, 1, (2, 3, 9)).astype(np.float32)
    np.testing.assert_allclose(S._segsum(torch.from_numpy(a)).numpy(),
                               np.asarray(JS._segsum(jnp.asarray(a))), **F32)


@pytest.mark.parametrize("Ssz", [1, 3, 17])
def test_causal_conv_matches_jax(Ssz):
    rng = np.random.default_rng(Ssz)
    xbc, w, b = (rng.normal(0, 1, s).astype(np.float32)
                 for s in ((2, Ssz, 12), (4, 12), (12,)))
    want = JS._causal_conv(*(jnp.asarray(a) for a in (xbc, w, b)))
    np.testing.assert_allclose(S._causal_conv(*_t((xbc, w, b))).numpy(),
                               np.asarray(want), **F32)


@pytest.mark.parametrize("with_init", [False, True], ids=["zeros", "init"])
@pytest.mark.parametrize("Ssz,chunk", [(32, 8), (64, 16), (24, 24), (16, 4)])
def test_ssd_chunked_matches_jax(Ssz, chunk, with_init):
    args = _ssd_inputs(2, Ssz, 3, 4, 8, seed=Ssz + chunk)
    init = (np.random.default_rng(1).normal(0, 1, (2, 3, 4, 8))
            .astype(np.float32) if with_init else None)
    jy, js = JS.ssd_chunked(*(jnp.asarray(a) for a in args), chunk,
                            init_state=None if init is None
                            else jnp.asarray(init))
    ty, ts = S.ssd_chunked(*_t(args), chunk, init_state=None if init is None
                           else torch.from_numpy(init))
    assert ts.dtype == torch.float32 and ts.shape == (2, 3, 4, 8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32)


def _ssd_naive(x, dt, A, Bm, Cm):
    """Token-by-token linear recurrence (the definition), in f64."""
    Bsz, Ssz, nh, P = x.shape
    state = np.zeros((Bsz, nh, P, Bm.shape[-1]))
    ys = []
    for t in range(Ssz):
        dA = np.exp(dt[:, t].astype(np.float64) * A[None, :])
        dBx = np.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t])
        state = state * dA[..., None, None] + dBx
        ys.append(np.einsum("bhpn,bn->bhp", state, Cm[:, t]))
    return np.stack(ys, 1), state


@pytest.mark.parametrize("Ssz,chunk", [(32, 8), (48, 16), (16, 16)])
def test_ssd_chunked_matches_naive_recurrence(Ssz, chunk):
    args = _ssd_inputs(2, Ssz, 3, 4, 8, seed=3)
    y, state = S.ssd_chunked(*_t(args), chunk)
    y_ref, state_ref = _ssd_naive(*args)
    np.testing.assert_allclose(y.numpy(), y_ref, **F32)
    np.testing.assert_allclose(state.numpy(), state_ref, **F32)


def test_ssd_chunked_refuses_a_ragged_chunk():
    with pytest.raises(AssertionError):
        S.ssd_chunked(*_t(_ssd_inputs(1, 20, 2, 4, 8, seed=0)), 8)


@pytest.mark.parametrize("Ssz", [10, 32])
def test_mamba2_block_matches_jax(Ssz):
    jcfg, cfg = _cfgs()
    jb, tb = _block(*_params(jcfg))
    h = np.random.default_rng(4).normal(0, 0.5, (2, Ssz, cfg.d_model)
                                        ).astype(np.float32)
    want = JS.mamba2_block(jb, jnp.asarray(h), jcfg)
    got = S.mamba2_block(tb, torch.from_numpy(h), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_mamba2_decode_matches_jax():
    jcfg, cfg = _cfgs()
    jb, tb = _block(*_params(jcfg))
    shapes = S.mamba2_cache_shape(cfg, 2)
    assert shapes == JS.mamba2_cache_shape(jcfg, 2)
    rng = np.random.default_rng(5)
    jc = {"ssm": jnp.asarray(rng.normal(0, 1, shapes["ssm"]), jnp.float32),
          "conv": jnp.asarray(rng.normal(0, 1, shapes["conv"]), jnp.float32)}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    for step in range(4):
        h = rng.normal(0, 0.5, (2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = JS.mamba2_decode(jb, jnp.asarray(h), jcfg, jc)
        ty, tc = S.mamba2_decode(tb, torch.from_numpy(h), cfg, tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **F32)


def test_mamba_decode_matches_block():
    # step-by-step decode == the full-sequence block at every position
    _, cfg = _cfgs()
    p = init_params(S.decls_mamba2(cfg), torch.Generator().manual_seed(0),
                    "cpu")
    h = torch.from_numpy(np.random.default_rng(3).normal(
        0, 0.5, (2, 10, cfg.d_model)).astype(np.float32))
    full = S.mamba2_block(p, h, cfg)
    cache = {k: torch.zeros(s) for k, s in S.mamba2_cache_shape(cfg, 2).items()}
    outs = []
    for t in range(10):
        y, cache = S.mamba2_decode(p, h[:, t:t + 1], cfg, cache)
        outs.append(y[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, atol=2e-4,
                               rtol=2e-3)


def test_decls_match_jax():
    jcfg, cfg = _cfgs()
    jd = jax.tree.map(lambda d: d.shape, jx_build(jcfg).decls,
                      is_leaf=lambda d: hasattr(d, "axes"))
    assert tree_map(lambda d: d.shape, build(cfg).decls) == jd
    assert S.ssm_dims(cfg) == JS.ssm_dims(jcfg)


def _tokens(cfg, B, Ssz, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, Ssz)).astype(np.int32)


@pytest.mark.parametrize("Ssz", [16, 64])
def test_ssm_prefill_matches_jax(Ssz):
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    toks = _tokens(cfg, 2, Ssz)
    jl, jc = JA._ssm_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = A._ssm_prefill(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    for name in ("ssm", "conv"):
        assert tc[name].shape == jc[name].shape
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **F32)


def test_ssm_decode_matches_jax():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    jcache = jx_init(JA._ssm_cache_decls(jcfg, 3, 8), jax.random.PRNGKey(0))
    tcache = init_params(A._ssm_cache_decls(cfg, 3, 8), torch.Generator(),
                         "cpu")
    assert tcache["ssm"].dtype == torch.float32
    toks = _tokens(cfg, 5, 3, seed=3)
    for step in range(5):
        batch = {"token": toks[step], "pos": np.full(3, step, np.int32)}
        jl, jcache = JA._ssm_decode(jp, jcache, jax.tree.map(jnp.asarray,
                                                             batch), jcfg)
        tl, tcache = A._ssm_decode(tp, tcache, {k: torch.from_numpy(v) for
                                                k, v in batch.items()}, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), **F32)


def test_ssm_bf16_compute_copy_keeps_decays_in_f32():
    _, cfg = _cfgs(compute_dtype="bfloat16")
    from repro_torch.models.api import compute_params
    p = init_params(build(cfg).decls, torch.Generator().manual_seed(0), "cpu")
    blk = compute_params(p, cfg)["layers"]["block"]
    for name in ("A_log", "dt_bias"):
        assert blk[name].dtype == torch.float32
        assert blk[name] is p["layers"]["block"][name]
    for name in ("in_proj", "conv_w", "conv_b", "D", "out_proj"):
        assert blk[name].dtype == torch.bfloat16
    assert blk["norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("batch,prompts", [
    (2, None), (1, "same_twice")], ids=["continuous", "slot_reused"])
def test_engine_matches_jax_engine(batch, prompts):
    # "slot_reused": two identical requests through one slot, the second
    # starting from the first's left-over SSM and conv state (neither
    # package resets a released slot)
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
    # the sequential recurrence (decode) against the chunked SSD (prefill)
    _, cfg = _cfgs()
    eng = Engine(cfg, batch=1, max_len=32, seed=0, device="cpu")
    prompt = np.array([5, 9, 3, 7, 11, 2, 40, 8], np.int32)
    logits, _ = eng.model.prefill(eng.params,
                                  {"tokens": torch.from_numpy(prompt)[None]})
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=1))
    eng.run_to_completion()
    assert eng.completed[0].out_tokens[0] == int(logits[0].argmax())
