"""The port's LM serving slice against the JAX package's: the dense model's
block prefill and decode step, and the continuous-batching engine, on the
smoke configs of qwen3-4b (qk-norm, untied embeddings here) and
llama3.2-3b (no qk-norm).  Parameters come from JAX's ``init_params`` and
are carried across by ``models/convert.py``.

Tolerances: at ``compute_dtype="float32"`` logits and caches within
atol = rtol = 1e-4 (the two frameworks' CPU matmuls sum in different
orders, through two layers); greedy token streams identical.  At bf16 the
port keeps scores and probabilities in f32 where JAX rounds them to bf16
(``layers._attend``): logits (|logit| ≲ 4) are held to atol 0.25, the
first layer's caches (bf16 projections, no attention before them) to
atol 1e-3 + rtol 1e-2, and every layer's to 5% of the cache's largest
entry (later layers see the first one's attention)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro.serve.engine import Engine as JxEngine
from repro.serve.engine import Request as JxRequest
from repro_torch.configs import get_config
from repro_torch.launch import serve as cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import build, compute_params
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.params import init_params, leaves, tree_map
from repro_torch.serve.engine import Engine, Request

ARCHS = ["qwen3-4b", "llama3.2-3b"]
F32 = dict(atol=1e-4, rtol=1e-4)


def _cfgs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (jx_get_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _params(jcfg, seed=0):
    jp = jx_init(jx_build(jcfg).decls, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decls_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jd = jax.tree.map(lambda d: d.shape, jx_build(jcfg).decls,
                      is_leaf=lambda d: hasattr(d, "axes"))
    assert tree_map(lambda d: d.shape, build(cfg).decls) == jd


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,chunk", [(12, 0), (64, 16)],
                         ids=["plain", "chunked"])
def test_prefill_matches_jax(arch, S, chunk):
    jcfg, cfg = _cfgs(arch, attn_chunk=chunk)
    jp, tp = _params(jcfg)
    toks = _tokens(cfg, 2, S)
    jl, jc = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = build(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    for name in ("k", "v"):
        assert tc[name].shape == (cfg.num_layers, 2, S, cfg.num_kv_heads,
                                  cfg.head_dim)
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **F32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_jax(arch, causal):
    # one layer's attention, the function training's forward will call
    jcfg, cfg = _cfgs(arch, attn_chunk=8)
    jp, tp = _params(jcfg)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tattn = tree_map(lambda a: a[0], tp["layers"]["attn"])
    x = np.random.default_rng(4).normal(0, 1, (2, 24, cfg.d_model)
                                        ).astype(np.float32)
    want = JL.attention(jattn, jnp.asarray(x), jcfg, causal=causal)
    got = L.attention(tattn, torch.from_numpy(x), cfg, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_bf16_close_to_jax(arch):
    jcfg, cfg = _cfgs(arch, compute_dtype="bfloat16")
    jp, tp = _params(jcfg)
    toks = _tokens(cfg, 2, 24)
    jl, jc = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = build(cfg).prefill(compute_params(tp, cfg),
                                {"tokens": torch.from_numpy(toks)})
    assert tc["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.25)
    for name in ("k", "v"):
        got, want = _f32(tc[name].float()), _f32(jc[name])
        np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=1e-2)
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    B, Tlen = 3, 8
    jcache = jx_init(JT.cache_decls(jcfg, B, Tlen), jax.random.PRNGKey(0))
    tcache = init_params(T.cache_decls(cfg, B, Tlen), torch.Generator(), "cpu")
    toks = _tokens(cfg, 4, B, seed=3)
    # slot 2 runs past the cache at the last step: JAX drops that write
    for step, pos in enumerate(([0, 0, 5], [1, 0, 6], [2, 1, 7], [3, 2, 8])):
        batch = {"token": toks[step], "pos": np.array(pos, np.int32)}
        jl, jcache = JT.decode_step(jp, jcache, jax.tree.map(jnp.asarray,
                                                             batch), jcfg)
        tl, tcache = T.decode_step(tp, tcache, {k: torch.from_numpy(v) for
                                                k, v in batch.items()}, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), **F32)


def _requests(cfg, cls, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                           int(rng.integers(2, 9))
                                           ).astype(np.int32),
                max_new_tokens=5) for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "t0.8"])
def test_engine_matches_jax_engine(arch, temperature):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    je = JxEngine(jcfg, params=jp, batch=3, max_len=48,
                  temperature=temperature, seed=0)
    te = Engine(cfg, params=tp, batch=3, max_len=48,
                temperature=temperature, seed=0, device="cpu")
    for eng, cls in ((je, JxRequest), (te, Request)):
        for r in _requests(cfg, cls):
            eng.submit(r)
    js, ts = je.run_to_completion(), te.run_to_completion()
    assert ts["completed"] == js["completed"] == 6
    assert ts["tokens"] == js["tokens"] == 30
    got = {r.rid: r.out_tokens for r in te.completed}
    assert got == {r.rid: r.out_tokens for r in je.completed}
    assert te.kv.free_slots() == [0, 1, 2]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_first_token_is_prefill_argmax(arch):
    _, cfg = _cfgs(arch)
    eng = Engine(cfg, batch=1, max_len=32, seed=0, device="cpu")
    prompt = np.array([5, 9, 3, 7, 11, 2], np.int32)
    logits, _ = eng.model.prefill(eng.params,
                                  {"tokens": torch.from_numpy(prompt)[None]})
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=1))
    eng.run_to_completion()
    assert eng.completed[0].out_tokens[0] == int(logits[0].argmax())


def test_compute_params_casts_weights_not_norms():
    _, cfg = _cfgs("qwen3-4b", compute_dtype="bfloat16")
    params = init_params(build(cfg).decls, torch.Generator().manual_seed(0),
                         "cpu")
    cp = compute_params(params, cfg)
    assert cp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert torch.equal(cp["embed"]["tok"], params["embed"]["tok"].bfloat16())
    for norm in (cp["ln_f"], cp["layers"]["ln1"], cp["layers"]["attn"]["q_norm"]):
        assert norm["scale"].dtype == torch.float32
    f32 = cfg.replace(compute_dtype="float32")
    assert all(a is b for a, b in zip(leaves(compute_params(params, f32)),
                                      leaves(params)))


def test_params_round_trip_through_numpy():
    jcfg, _ = _cfgs("qwen3-4b")
    jp, tp = _params(jcfg)
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b)


def test_cli_serves_every_request_on_cpu(capsys):
    args = cli.build_parser().parse_args(
        ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--requests",
         "5", "--batch", "2", "--max-new", "3"])
    rep = cli.run_lm_serve(args)
    assert rep["stats"]["completed"] == 5 and rep["stats"]["tokens"] == 15
    assert all(r.status == "done" and len(r.out_tokens) == 3
               for r in rep["engine"].completed)
    assert "[result] 5 requests, 15 tokens" in capsys.readouterr().out
    assert cli.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                     "--requests", "2", "--max-new", "2"]) == 0


def test_cli_defaults_to_cuda_and_refuses_other_families():
    # every LM family is served now; only an arch that is not registered is
    # refused
    args = cli.build_parser().parse_args(["--arch", "qwen3-4b"])
    assert args.device == "cuda"
    assert (args.requests, args.batch, args.max_len, args.max_new,
            args.prompt_len, args.temperature) == (8, 4, 128, 12, 8, 0.0)
    for arch in ("whisper-medium", "qwen2-vl-2b"):
        assert cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "2", "--max-new", "2"]) == 0
    with pytest.raises(SystemExit, match="unknown --arch"):
        cli.main(["--arch", "no-such-lm", "--smoke", "--device", "cpu"])


def test_build_refuses_non_dense_families():
    # the encdec and vlm families and the layer kinds they brought (NoPE
    # with pos_emb, M-RoPE, the GELU and relu² MLPs) build with the JAX
    # package's declarations, and the dense-stack variants' prefill matches
    # JAX's
    for arch in ("whisper-medium", "qwen2-vl-2b"):
        jcfg, cfg = _cfgs(arch)
        assert build(cfg).cfg.family == jcfg.family
        jd = jax.tree.map(lambda d: d.shape, jx_build(jcfg).decls,
                          is_leaf=lambda d: hasattr(d, "axes"))
        assert tree_map(lambda d: d.shape, build(cfg).decls) == jd
    toks = _tokens(get_config("qwen3-4b", smoke=True), 2, 12)
    mrope = np.broadcast_to(np.arange(12), (3, 2, 12)).astype(np.int32)
    for arch, kw in (("qwen3-4b", dict(use_rope=False)),
                     ("qwen3-4b", dict(mrope_sections=(2, 3, 3))),
                     ("qwen3-4b", dict(mlp_type="gelu")),
                     ("qwen3-4b", dict(family="moe", use_rope=False)),
                     ("zamba2-7b", dict(mlp_type="relu2"))):
        jcfg, cfg = _cfgs(arch, **kw)
        jd = jax.tree.map(lambda d: d.shape, jx_build(jcfg).decls,
                          is_leaf=lambda d: hasattr(d, "axes"))
        assert tree_map(lambda d: d.shape, build(cfg).decls) == jd
        jp, tp = _params(jcfg)
        batch = {"tokens": toks}
        if cfg.mrope_sections:
            batch["positions"] = mrope
        jl, _ = jx_build(jcfg).prefill(jp, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        tl, _ = build(cfg).prefill(tp, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
