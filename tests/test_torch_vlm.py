"""The port's VLM (qwen2-vl-2b: the dense model with M-RoPE and a stubbed
vision prefix) and the learned-position branch of ``models/transformer.py``
against the JAX package's, on smoke configs (qwen2-vl: 2 layers, d 64, 4
q-heads over 2 kv-heads, Dh 16, M-RoPE sections (2, 3, 3)).

The prefill's inputs are built as Qwen2-VL builds them: ``vision_embeds``
over the first VP token rows (a side × side patch grid at t = 0, h = i //
side, w = i % side) and text token j >= VP at side + (j - VP) on all three
streams (``grid_positions``; ``chip_smoke.py`` builds the same at VP =
1024, side 32).  Parameters: ``scaled_params`` for the f32 comparisons and
JAX's ``init_params`` for the engine (``tests/test_torch_encdec.py`` says
why).

Tolerances: M-RoPE angles bit-equal (given the same frequencies: the two
packages' ``rope_freqs`` differ by an ulp at some widths); f32 outputs,
logits and caches within 1e-5 of their largest magnitude; bf16 logits
within atol 0.25 and caches within 5% of their largest entry
(``tests/test_torch_lm.py``); greedy streams identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import build as jx_build
from repro.serve.engine import Engine as JxEngine
from repro.serve.engine import Request as JxRequest
from repro_torch.configs import get_config
from repro_torch.launch import serve as cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import VISION_PREFIX, build, compute_params
from repro_torch.models.params import init_params, tree_map
from repro_torch.serve.engine import Engine, Request
from test_torch_encdec import (_close, _jax_init_params, _jx, _params, _t,
                               scaled_params)

ARCH = "qwen2-vl-2b"


def _cfgs(arch=ARCH, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (jx_get_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def grid_positions(B, S, vp, side):
    """(3, B, S) int32: a side × side patch grid over the first vp rows,
    then the text on all three streams from ``side`` on."""
    i = np.arange(S)
    t = np.where(i < vp, 0, side + i - vp)
    h = np.where(i < vp, i // side, t)
    w = np.where(i < vp, i % side, t)
    return np.broadcast_to(np.stack([t, h, w])[:, None], (3, B, S)
                           ).astype(np.int32).copy()


def _vlm_batch(cfg, B=2, S=24, vp=16, side=4, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "vision_embeds": rng.normal(0, 1, (B, vp, cfg.d_model)
                                        ).astype(np.float32),
            "positions": grid_positions(B, S, vp, side)}


def _text_batch(cfg, B=2, S=20, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    pos = np.broadcast_to(np.arange(S), (3, B, S))
    return {"tokens": toks.astype(np.int32),
            "positions": pos.astype(np.int32).copy()}


def _jax_angles(positions, freqs, sections):
    """The angles of JAX's ``apply_mrope``, its expressions written out."""
    sec_id = jnp.repeat(jnp.arange(len(sections)), jnp.array(sections),
                        total_repeat_length=freqs.shape[0])
    ang_all = positions.astype(jnp.float32)[..., None] * freqs
    sel = jax.nn.one_hot(sec_id, len(sections), dtype=jnp.float32)
    return jnp.einsum("k...f,fk->...f", ang_all, sel)


def test_grid_positions_are_qwen2_vls():
    pos = grid_positions(1, 1030, VISION_PREFIX, 32)
    assert pos.shape == (3, 1, 1030)
    assert (pos[0, 0, :1024] == 0).all()
    assert pos[1, 0, 33] == 1 and pos[2, 0, 33] == 1
    assert pos[1, 0, 1023] == 31 and pos[2, 0, 1023] == 31
    assert (pos[:, 0, 1024] == 32).all() and (pos[:, 0, 1029] == 37).all()


def test_decls_match_jax():
    jcfg, cfg = _cfgs()
    jd = jax.tree.map(lambda d: d.shape, jx_build(jcfg).decls,
                      is_leaf=lambda d: hasattr(d, "axes"))
    assert tree_map(lambda d: d.shape, build(cfg).decls) == jd
    assert "pos_emb" not in jd


@pytest.mark.parametrize("sections,dh,theta", [((2, 3, 3), 16, 1e4),
                                               ((16, 24, 24), 128, 1e6)])
def test_mrope_angles_bit_equal(sections, dh, theta):
    # three distinct streams, so a slot reading the wrong one shows
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 5000, (3, 2, 33)).astype(np.int32)
    freqs = JL.rope_freqs(dh, theta)
    want = _jax_angles(jnp.asarray(pos), freqs, sections)
    got = L.mrope_angles(torch.from_numpy(pos),
                         torch.from_numpy(np.array(freqs)), sections)
    assert got.dtype == torch.float32 and got.shape == (2, 33, dh // 2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # and the rotation applied with them
    x = rng.normal(0, 1, (2, 33, 3, dh)).astype(np.float32)
    _close(L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta,
                         sections).numpy(),
           JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections))


@pytest.mark.parametrize("kind", ["vision", "text"])
def test_prefill_matches_jax(kind):
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    batch = _vlm_batch(cfg) if kind == "vision" else _text_batch(cfg)
    jl, jc = JT.prefill(jp, _jx(batch), jcfg)
    tl, tc = build(cfg).prefill(tp, _t(batch))
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_size)
    _close(tl.numpy(), jl)
    for name in ("k", "v"):
        assert tc[name].shape == (cfg.num_layers, 2, batch["tokens"].shape[1],
                                  cfg.num_kv_heads, cfg.head_dim)
        _close(tc[name].numpy(), jc[name])


def test_vision_embeds_overwrite_the_prefix():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    batch = _vlm_batch(cfg)
    got = T._embed_input(tp, _t(batch), cfg)
    assert torch.equal(got[:, :16], torch.from_numpy(batch["vision_embeds"]))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JT._embed_input(jp, _jx(batch), jcfg)))


def test_prefill_bf16_close_to_jax():
    jcfg, cfg = _cfgs(compute_dtype="bfloat16")
    jp, tp = _params(jcfg)
    batch = _vlm_batch(cfg)
    jl, jc = JT.prefill(jp, _jx(batch), jcfg)
    tl, tc = build(cfg).prefill(compute_params(tp, cfg), _t(batch))
    assert tc["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.25)
    for name in ("k", "v"):
        got = tc[name].float().numpy()
        want = np.asarray(jc[name], np.float32)
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_decode_steps_match_jax():
    # after a vision prefill: each step's positions (3, B, 1) continue the
    # text streams; slot 1 runs past the cache at the last step
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    batch = _vlm_batch(cfg)
    _, jc = JT.prefill(jp, _jx(batch), jcfg)
    _, tc = T.prefill(tp, _t(batch), cfg)
    S, Tlen = batch["tokens"].shape[1], 28
    jcache = {n: jnp.zeros((cfg.num_layers, 2, Tlen, cfg.num_kv_heads,
                            cfg.head_dim)).at[:, :, :S].set(jc[n])
              for n in ("k", "v")}
    tcache = init_params(T.cache_decls(cfg, 2, Tlen), torch.Generator(),
                         "cpu")
    for n in ("k", "v"):
        tcache[n][:, :, :S] = tc[n]
    nxt = np.random.default_rng(5).integers(0, cfg.vocab_size, (5, 2)
                                            ).astype(np.int32)
    for step, pos in enumerate(([24, 24], [25, 25], [26, 26], [27, 27],
                                [27, 28])):
        pos = np.array(pos, np.int32)
        b = {"token": nxt[step], "pos": pos,
             "positions": np.broadcast_to((pos - 16 + 4)[None, :, None],
                                          (3, 2, 1)).copy()}
        jl, jcache = JT.decode_step(jp, jcache, _jx(b), jcfg)
        tl, tcache = T.decode_step(tp, tcache, _t(b), cfg)
        _close(tl.numpy(), jl)
        for name in ("k", "v"):
            _close(tcache[name].numpy(), jcache[name])


def test_engine_matches_jax_engine():
    # the engine hands a decode step each slot's position on all three
    # streams, (3, B, 1), as the JAX engine does
    jcfg, cfg = _cfgs()
    jp, tp = _jax_init_params(jcfg)
    je = JxEngine(jcfg, params=jp, batch=2, max_len=32, seed=0)
    te = Engine(cfg, params=tp, batch=2, max_len=32, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(2, 9))
                            ).astype(np.int32) for _ in range(5)]
    for eng, cls in ((je, JxRequest), (te, Request)):
        for rid, pr in enumerate(prompts):
            eng.submit(cls(rid=rid, prompt=pr, max_new_tokens=5))
    assert te._make_batch({}, {})["positions"].shape == (3, 2, 1)
    js, ts = je.run_to_completion(), te.run_to_completion()
    assert ts["completed"] == js["completed"] == 5
    assert ({r.rid: r.out_tokens for r in te.completed}
            == {r.rid: r.out_tokens for r in je.completed})


def test_mrope_prefill_without_positions_raises():
    # JAX hands apply_mrope a (B, S) stream there, which broadcasts only at
    # B = 3, reading batch rows as the (t, h, w) streams; the port refuses
    _, cfg = _cfgs()
    params = init_params(build(cfg).decls, torch.Generator().manual_seed(0),
                         "cpu")
    toks = torch.randint(0, cfg.vocab_size, (3, 10))
    with pytest.raises(ValueError, match="M-RoPE needs positions"):
        build(cfg).prefill(params, {"tokens": toks})


@pytest.mark.parametrize("with_positions", [False, True],
                         ids=["prefix", "positions"])
def test_dense_pos_emb_matches_jax(with_positions):
    # a dense config without RoPE: a learned pos_emb row per position, by
    # the prefix or by (B, S) positions, and by pos in a decode step
    jcfg, cfg = _cfgs("qwen3-4b", use_rope=False)
    jd = jax.tree.map(lambda d: d.shape, jx_build(jcfg).decls,
                      is_leaf=lambda d: hasattr(d, "axes"))
    assert tree_map(lambda d: d.shape, build(cfg).decls) == jd
    assert jd["pos_emb"] == (cfg.max_seq, cfg.d_model)
    tree = scaled_params(jx_build(jcfg).decls, seed=3)
    tree["pos_emb"] = np.random.default_rng(4).normal(
        0, 1, tree["pos_emb"].shape).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, tree), _t_tree(tree)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12)
                                    ).astype(np.int32)}
    if with_positions:
        batch["positions"] = (np.arange(12)[None] + np.array([[3], [40]])
                              ).astype(np.int32)
    jl, jc = JT.prefill(jp, _jx(batch), jcfg)
    tl, tc = T.prefill(tp, _t(batch), cfg)
    _close(tl.numpy(), jl)
    for name in ("k", "v"):
        _close(tc[name].numpy(), jc[name])
    b = {"token": np.array([5, 9], np.int32), "pos": np.array([12, 3],
                                                              np.int32)}
    jcache = {n: jnp.zeros((cfg.num_layers, 2, 16, cfg.num_kv_heads,
                            cfg.head_dim)) for n in ("k", "v")}
    tcache = init_params(T.cache_decls(cfg, 2, 16), torch.Generator(), "cpu")
    jl, _ = JT.decode_step(jp, jcache, _jx(b), jcfg)
    tl, _ = T.decode_step(tp, tcache, _t(b), cfg)
    _close(tl.numpy(), jl)


def _t_tree(tree):
    return tree_map(lambda a: torch.from_numpy(a), tree)


def test_cli_serves_qwen2_vl_on_cpu(capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
            "--batch", "2", "--max-new", "4"]
    rep = cli.run_lm_serve(cli.build_parser().parse_args(argv))
    assert rep["stats"]["completed"] == 3 and rep["stats"]["tokens"] == 12
    cfg = rep["engine"].cfg
    assert cfg.family == "vlm" and cfg.mrope_sections == (2, 3, 3)
    assert all(0 <= t < cfg.vocab_size for r in rep["engine"].completed
               for t in r.out_tokens)
    assert "[result] 3 requests, 12 tokens" in capsys.readouterr().out
