"""The port's encoder-decoder (``models/encdec.py``, whisper-medium) and its
new layer kinds (``layernorm``, the GELU and relu² MLPs, ``cross_kv`` /
``attention_cross``) against the JAX package's, on the whisper smoke config
(2 + 2 layers, d 64, 4 heads, a 30-frame encoder: a ragged tile of the
kernel's plain version).  The same parameter tree goes to both packages,
through ``models/convert.py``; inputs come from a numpy seed.

Parameters.  The engine and CLI tests use JAX's ``init_params``.  The f32
comparisons use ``scaled_params``: the same tree drawn in numpy with each
weight scaled by its whole fan-in and every norm's scale and bias drawn.
JAX's initializer reads the fan-in from a weight's second-to-last axis, so
``wv (D, Hkv, Dh)`` gets 1/sqrt(Hkv) and ``wo (H, Dh, D)`` 1/sqrt(Dh); the
seeded smoke stack then amplifies noise so much that the JAX package moves
its own logits by up to 8e-5 of their largest when its input is perturbed
by one ulp (relative 1e-7).  No two summation orders can agree to 1e-5
there.  Under ``scaled_params`` that spread is 4e-7, and a fault of 1e-5
shows.

Tolerances: at ``compute_dtype="float32"`` every output, logit and cache
leaf within 1e-5 of its largest magnitude (max |port - JAX| <= 1e-5 max
|JAX|: the norm-wise measure of ``chip_smoke.py``'s ``LOGITS_REL_TOL``);
at bf16 the logits within atol 0.25 (``tests/test_torch_lm.py``: the port
keeps attention scores in f32), the caches within 5% of their largest
entry and a layernorm within one bf16 rounding; greedy streams
identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro.serve.engine import Engine as JxEngine
from repro.serve.engine import Request as JxRequest
from repro_torch.configs import get_config
from repro_torch.launch import serve as cli
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models.api import build, compute_params
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import init_params, tree_map
from repro_torch.serve.engine import Engine, Request

ARCH = "whisper-medium"
F32_REL = 1e-5
CACHES = ("k", "v", "xk", "xv")


def _cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return (jx_get_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


# weights drawn N(0, 1 / fan-in): the axes a weight contracts (after the
# layer axis of a stacked leaf)
FAN_IN_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1,
               "w_down": 1, "out": 1}
STACKS = ("layers", "encoder", "decoder")


def scaled_params(decls, seed=0):
    """A parameter tree of numpy arrays for ``decls`` (JAX ``ParamDecl``s):
    weights N(0, 1 / their whole fan-in), norm scales U(0.5, 1.5), biases
    N(0, 0.1), ``normal`` leaves (embeddings, position tables) N(0, their
    scale)."""
    rng = np.random.default_rng(seed)

    def draw(tree, key=None, stacked=False):
        if isinstance(tree, dict):
            return {k: draw(v, k, stacked or k in STACKS)
                    for k, v in tree.items()}
        shape = tree.shape
        if tree.init == "ones":
            x = rng.uniform(0.5, 1.5, shape)
        elif tree.init == "zeros":
            x = rng.normal(0, 0.1, shape)
        elif tree.init == "normal":
            x = rng.normal(0, tree.scale, shape)
        else:
            core = shape[1:] if stacked else shape
            x = rng.standard_normal(shape) / np.sqrt(
                np.prod(core[:FAN_IN_AXES[key]]))
        return x.astype(np.float32)
    return draw(decls)


def _params(jcfg, seed=0):
    """``scaled_params`` of the config, as JAX arrays and port tensors."""
    tree = scaled_params(jx_build(jcfg).decls, seed)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu")


def _jax_init_params(jcfg, seed=0):
    jp = jx_init(jx_build(jcfg).decls, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(cfg, B=2, S=12, seed=1):
    rng = np.random.default_rng(seed)
    audio = rng.normal(0, 1, (B, cfg.encoder_seq, cfg.d_model)
                       ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return audio, toks


def _close(got, want, tol=F32_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * top, f"max |diff| {err} > {tol} x max |want| {top}"


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _layer0(jp, tp, stack):
    return (jax.tree.map(lambda a: a[0], jp[stack]),
            tree_map(lambda a: a[0], tp[stack]))


def test_decls_match_jax():
    jcfg, cfg = _cfgs()
    jd = jax.tree.map(lambda d: d.shape, jx_build(jcfg).decls,
                      is_leaf=lambda d: hasattr(d, "axes"))
    assert tree_map(lambda d: d.shape, build(cfg).decls) == jd
    jc = jax.tree.map(lambda d: (d.shape, jnp.dtype(d.dtype).name),
                      JE.cache_decls(jcfg, 3, 16),
                      is_leaf=lambda d: hasattr(d, "axes"))
    tc = tree_map(lambda d: (d.shape, str(d.dtype).replace("torch.", "")),
                  E.cache_decls(cfg, 3, 16))
    assert tc == jc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    jcfg, cfg = _cfgs()
    assert cfg.norm_eps == 1e-6
    rng = np.random.default_rng(2)
    x = rng.normal(0.5, 2, (3, 7, cfg.d_model)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, cfg.d_model).astype(np.float32),
         "bias": rng.normal(0, 0.3, cfg.d_model).astype(np.float32)}
    want = JL.layernorm(_jx(p), jnp.asarray(x).astype(dtype), jcfg.norm_eps)
    got = L.layernorm(_t(p), torch.from_numpy(x).to(getattr(torch, dtype)),
                      cfg.norm_eps)
    assert got.dtype == getattr(torch, dtype)
    w = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        _close(got.numpy(), w)
    else:   # the same f32 value rounded: at most one bf16 ulp apart
        np.testing.assert_allclose(got.float().numpy(), w, atol=1e-6,
                                   rtol=2 ** -8)


@pytest.mark.parametrize("mlp_type", ["gelu", "relu2"])
def test_mlp_kinds_match_jax(mlp_type):
    jcfg, cfg = _cfgs(mlp_type=mlp_type)
    jd = jax.tree.map(lambda d: d.shape, JL.decls_mlp(jcfg),
                      is_leaf=lambda d: hasattr(d, "axes"))
    assert tree_map(lambda d: d.shape, L.decls_mlp(cfg)) == jd
    rng = np.random.default_rng(3)
    p = {k: rng.normal(0, 0.3, s).astype(np.float32) for k, s in jd.items()}
    x = rng.normal(0, 1, (2, 5, cfg.d_model)).astype(np.float32)
    want = JL.mlp(_jx(p), jnp.asarray(x), jcfg)
    got = L.mlp(_t(p), torch.from_numpy(x), cfg)
    _close(got.numpy(), np.asarray(want))


def test_cross_attention_matches_jax():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    jx_, tx = _layer0(jp, tp, "decoder")
    rng = np.random.default_rng(4)
    enc = rng.normal(0, 1, (2, cfg.encoder_seq, cfg.d_model)
                     ).astype(np.float32)
    x = rng.normal(0, 1, (2, 9, cfg.d_model)).astype(np.float32)
    jkv = JL.cross_kv(jx_["xattn"], jnp.asarray(enc), jcfg)
    tkv = L.cross_kv(tx["xattn"], torch.from_numpy(enc), cfg)
    for got, want in zip(tkv, jkv):
        assert got.shape == (2, cfg.encoder_seq, cfg.num_kv_heads,
                             cfg.head_dim)
        _close(got.numpy(), np.asarray(want))
    want = JL.attention_cross(jx_["xattn"], jnp.asarray(x), jkv, jcfg)
    got = L.attention_cross(tx["xattn"], torch.from_numpy(x), tkv, cfg)
    _close(got.numpy(), np.asarray(want))


def test_encode_matches_jax():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    audio, _ = _inputs(cfg)
    want = JE.encode(jp, jnp.asarray(audio), jcfg)
    got = E.encode(tp, torch.from_numpy(audio), cfg)
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    _close(got.numpy(), np.asarray(want))


def test_decoder_fwd_matches_jax():
    # the teacher-forced decoder, the tests' oracle of the prefill's logits
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    audio, toks = _inputs(cfg, S=16)
    jenc = JE.encode(jp, jnp.asarray(audio), jcfg)
    want = JE._decoder_fwd(jp, jnp.asarray(toks), jenc, jcfg)
    got = E._decoder_fwd(tp, torch.from_numpy(toks),
                         torch.from_numpy(np.array(jenc)), cfg)
    _close(got.numpy(), np.asarray(want))
    W = L.unembed_matrix(tp["embed"], cfg, got.dtype)
    logits, _ = E.prefill(tp, _t({"audio_embeds": audio, "tokens": toks}),
                          cfg)
    _close(logits.numpy(), (got[:, -1] @ W).numpy())


@pytest.mark.parametrize("S", [1, 12, 40])
def test_prefill_matches_jax(S):
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    audio, toks = _inputs(cfg, S=S)
    batch = {"audio_embeds": audio, "tokens": toks}
    jl, jc = JE.prefill(jp, _jx(batch), jcfg)
    tl, tc = build(cfg).prefill(tp, _t(batch))
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_size)
    _close(tl.numpy(), np.asarray(jl))
    assert set(tc) == set(CACHES)
    for name in CACHES:
        assert tc[name].shape == jc[name].shape
        _close(tc[name].numpy(), np.asarray(jc[name]))


def test_prefill_bf16_close_to_jax():
    jcfg, cfg = _cfgs(compute_dtype="bfloat16")
    jp, tp = _params(jcfg)
    audio, toks = _inputs(cfg, S=20)
    batch = {"audio_embeds": audio, "tokens": toks}
    jl, jc = JE.prefill(jp, _jx(batch), jcfg)
    tl, tc = build(cfg).prefill(compute_params(tp, cfg), _t(batch))
    assert all(tc[n].dtype == torch.bfloat16 for n in CACHES)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.25)
    for name in CACHES:
        got = tc[name].float().numpy()
        want = np.asarray(jc[name], np.float32)
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def _filled_caches(jcfg, cfg, jc, tc, B, T):
    """Decode caches of length T holding a prefill's k/v in [0, S) and its
    cross caches, in both packages."""
    S = jc["k"].shape[2]
    jcache = jx_init(JE.cache_decls(jcfg, B, T), jax.random.PRNGKey(0))
    tcache = init_params(E.cache_decls(cfg, B, T), torch.Generator(), "cpu")
    for n in ("k", "v"):
        jcache[n] = jcache[n].at[:, :, :S].set(jc[n])
        tcache[n][:, :, :S] = tc[n]
    for n in ("xk", "xv"):
        jcache[n] = jc[n]
        tcache[n] = tc[n].clone()
    return jcache, tcache


def test_decode_steps_match_jax():
    # after a block prefill, so the cross caches hold the encoder's k/v;
    # slot 1 runs past the cache at the last step (JAX drops that write)
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    audio, toks = _inputs(cfg, B=2, S=5)
    batch = {"audio_embeds": audio, "tokens": toks}
    _, jc = JE.prefill(jp, _jx(batch), jcfg)
    _, tc = E.prefill(tp, _t(batch), cfg)
    jcache, tcache = _filled_caches(jcfg, cfg, jc, tc, 2, 8)
    nxt = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 2)
                                            ).astype(np.int32)
    for step, pos in enumerate(([5, 5], [6, 6], [7, 7], [7, 8])):
        b = {"token": nxt[step], "pos": np.array(pos, np.int32)}
        jl, jcache = JE.decode_step(jp, jcache, _jx(b), jcfg)
        tl, tcache = E.decode_step(tp, tcache, _t(b), cfg)
        _close(tl.numpy(), np.asarray(jl))
        for name in CACHES:
            _close(tcache[name].numpy(),
                                       np.asarray(jcache[name]))


def _requests(cfg, cls, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                           int(rng.integers(2, 9))
                                           ).astype(np.int32),
                max_new_tokens=5) for i in range(n)]


def test_engine_matches_jax_engine():
    # neither engine runs the encoder: the cross caches stay the zeros of
    # cache_decls, in both packages
    jcfg, cfg = _cfgs()
    jp, tp = _jax_init_params(jcfg)
    je = JxEngine(jcfg, params=jp, batch=2, max_len=32, seed=0)
    te = Engine(cfg, params=tp, batch=2, max_len=32, seed=0, device="cpu")
    for eng, cls in ((je, JxRequest), (te, Request)):
        for r in _requests(cfg, cls):
            eng.submit(r)
    js, ts = je.run_to_completion(), te.run_to_completion()
    assert ts["completed"] == js["completed"] == 5
    assert ({r.rid: r.out_tokens for r in te.completed}
            == {r.rid: r.out_tokens for r in je.completed})
    for name in ("xk", "xv"):
        assert not te.kv.caches[name].any()
        assert not np.asarray(je.kv.caches[name]).any()


def test_engine_cross_branch_adds_nothing_to_served_tokens():
    # with zero cross caches the softmax averages zero values: the decode
    # step's logits equal those of the same step with the cross weights'
    # output projection zeroed
    _, cfg = _cfgs()
    eng = Engine(cfg, batch=2, max_len=16, seed=0, device="cpu")
    silent = {**eng.params, "decoder": {**eng.params["decoder"], "xattn": {
        **eng.params["decoder"]["xattn"],
        "wo": torch.zeros_like(eng.params["decoder"]["xattn"]["wo"])}}}
    b = {"token": torch.tensor([3, 9]), "pos": torch.tensor([0, 0])}
    caches = init_params(E.cache_decls(cfg, 2, 16), torch.Generator(), "cpu")
    with torch.no_grad():
        got, _ = eng.model.decode(eng.params, caches, b)
        caches = init_params(E.cache_decls(cfg, 2, 16), torch.Generator(),
                             "cpu")
        want, _ = eng.model.decode(silent, caches, b)
    assert torch.equal(got, want)


def test_pos_dec_index_past_the_table_is_clamped():
    # JAX's gather clamps an index past pos_dec to its last row
    jcfg, cfg = _cfgs(max_seq=8)
    jp, tp = _params(jcfg)
    jcache = jx_init(JE.cache_decls(jcfg, 2, 12), jax.random.PRNGKey(0))
    tcache = init_params(E.cache_decls(cfg, 2, 12), torch.Generator(), "cpu")
    b = {"token": np.array([4, 7], np.int32), "pos": np.array([7, 10],
                                                              np.int32)}
    jl, _ = JE.decode_step(jp, jcache, _jx(b), jcfg)
    tl, _ = E.decode_step(tp, tcache, _t(b), cfg)
    _close(tl.numpy(), np.asarray(jl))


def test_cli_serves_whisper_on_cpu(capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
            "--batch", "2", "--max-new", "4"]
    rep = cli.run_lm_serve(cli.build_parser().parse_args(argv))
    assert rep["stats"]["completed"] == 3 and rep["stats"]["tokens"] == 12
    assert rep["engine"].cfg.family == "encdec"
    assert set(rep["engine"].kv.caches) == set(CACHES)
    assert "[result] 3 requests, 12 tokens" in capsys.readouterr().out
