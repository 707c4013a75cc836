"""The LM families slice as a whole: the dense glm4-9b (smoke Dh 8, kv 2)
and minitron-8b against the JAX package's model and engine, and the
launcher serving every arch of the dense, MoE, SSM, hybrid,
encoder-decoder and VLM families (``--smoke --device cpu``).

Tolerances: ``tests/test_torch_lm.py``'s, atol = rtol = 1e-4 at
``compute_dtype="float32"``; greedy streams identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models import transformer as JT
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro.serve.engine import Engine as JxEngine
from repro.serve.engine import Request as JxRequest
from repro_torch.configs import get_config
from repro_torch.launch import serve as cli
from repro_torch.models import transformer as T
from repro_torch.models.api import F32_LEAVES, build, compute_params
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import init_params
from repro_torch.serve.engine import Engine, Request

DENSE = ["glm4-9b", "minitron-8b"]
SERVED = DENSE + ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "mamba2-1.3b",
                  "zamba2-7b"]
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


@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    toks = _tokens(cfg, 2, 40)
    jl, jc = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = build(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **F32)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_decode_step_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    jcache = jx_init(JT.cache_decls(jcfg, 2, 8), jax.random.PRNGKey(0))
    tcache = init_params(T.cache_decls(cfg, 2, 8), torch.Generator(), "cpu")
    toks = _tokens(cfg, 3, 2, seed=3)
    for step, pos in enumerate(([0, 3], [1, 4], [2, 5])):
        batch = {"token": toks[step], "pos": np.array(pos, np.int32)}
        jl, jcache = JT.decode_step(jp, jcache, jax.tree.map(jnp.asarray,
                                                             batch), jcfg)
        tl, tcache = T.decode_step(tp, tcache, {k: torch.from_numpy(v) for
                                                k, v in batch.items()}, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_engine_matches_jax_engine(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    je = JxEngine(jcfg, params=jp, batch=2, max_len=32, seed=0)
    te = Engine(cfg, params=tp, batch=2, max_len=32, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(2, 9))
                            ).astype(np.int32) for _ in range(4)]
    for eng, cls in ((je, JxRequest), (te, Request)):
        for rid, pr in enumerate(prompts):
            eng.submit(cls(rid=rid, prompt=pr, max_new_tokens=5))
    je.run_to_completion()
    te.run_to_completion()
    assert ({r.rid: r.out_tokens for r in te.completed}
            == {r.rid: r.out_tokens for r in je.completed})


@pytest.mark.parametrize("arch", SERVED)
def test_cli_serves_every_new_arch_on_cpu(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--batch", "2", "--max-new", "3"]
    rep = cli.run_lm_serve(cli.build_parser().parse_args(argv))
    assert rep["stats"]["completed"] == 3 and rep["stats"]["tokens"] == 9
    cfg = rep["engine"].cfg
    assert all(r.status == "done" and len(r.out_tokens) == 3
               and all(0 <= t < cfg.vocab_size for t in r.out_tokens)
               for r in rep["engine"].completed)
    assert "[result] 3 requests, 9 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-2b"])
def test_cli_refuses_encdec_and_vlm(arch, capsys):
    # the encoder-decoder and VLM families are served: every request done,
    # every token in range, the family's cache tree kept
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--batch", "2", "--max-new", "3"]
    rep = cli.run_lm_serve(cli.build_parser().parse_args(argv))
    eng = rep["engine"]
    assert rep["stats"]["completed"] == 3 and rep["stats"]["tokens"] == 9
    assert all(r.status == "done" and len(r.out_tokens) == 3
               and all(0 <= t < eng.cfg.vocab_size for t in r.out_tokens)
               for r in eng.completed)
    want = {"k", "v"} | ({"xk", "xv"} if eng.cfg.family == "encdec"
                         else set())
    assert set(eng.kv.caches) == want
    assert "[result] 3 requests, 9 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", SERVED + ["whisper-medium", "qwen2-vl-2b"])
def test_compute_params_keeps_the_f32_reads(arch):
    # JAX reads norm scales, LayerNorm biases, the router, A_log and
    # dt_bias in f32 from the f32 master at every use; everything else in
    # the compute dtype
    _, cfg = _cfgs(arch, compute_dtype="bfloat16")
    params = init_params(build(cfg).decls, torch.Generator().manual_seed(0),
                         "cpu")
    kept = []

    def walk(master, copy, key=None):
        if isinstance(master, dict):
            for k in master:
                walk(master[k], copy[k], k)
        elif key in F32_LEAVES:
            assert copy is master and copy.dtype == torch.float32
            kept.append(key)
        else:
            assert copy.dtype == torch.bfloat16
            assert torch.equal(copy, master.bfloat16())
    walk(params, compute_params(params, cfg))
    want = {"scale"} | ({"router"} if cfg.is_moe else set()) | (
        {"A_log", "dt_bias"} if cfg.family in ("ssm", "hybrid") else set()) | (
        {"bias"} if cfg.family == "encdec" else set())
    assert set(kept) == want
