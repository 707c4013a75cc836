"""The port's LM training path against the JAX package's, on the CPU at
smoke size, f32 compute (``compute_dtype="float32"``), the same numpy
inputs and the same parameters (JAX's ``init_params``, carried across by
``models/convert.py``; ``scaled_params`` for a stack whose f32 gradients
are chaotic, ``CHAOTIC``):

  * ``Model.loss_fn`` and every leaf's gradient against
    ``jax.value_and_grad(model.loss_fn)`` for the dense, MoE, SSM, hybrid
    and encoder-decoder families: the loss within 1e-5 of its size, each
    leaf's max |port - JAX| <= 1e-4 x that leaf's max |JAX gradient|, and
    every leaf gets a gradient;
  * ``remat`` none / full / dots: bit-equal gradients;
  * ``lm_loss`` with ``loss_chunk`` against JAX's, value and gradients;
  * four ``make_train_step`` steps (AdamW, clipped, and with
    ``grad_accum=2``) against JAX's losses within rel 1e-4; Adafactor, SGD
    and Lion in-place updates from the same gradients within 1e-6 of
    JAX's; AdamW's in-place update bit-equal to its functional form;
  * ``SyntheticTokens`` / ``PrefetchLoader`` batches bit-equal to JAX's;
  * the launcher's LM path prints JAX's lines and commits the checkpoints
    JAX's supervisor commits, leaf for leaf by name.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.launch import train as jx_launch
from repro.models import layers as JL
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro.train import data as jx_data
from repro.train import optimizer as jx_opt
from repro.train.checkpoint import CheckpointManager as JxCkpt
from repro.train.trainer import make_train_step as jx_make_train_step
from repro_torch.configs import get_config
from repro_torch.launch.train import main
from repro_torch.models import layers as L
from repro_torch.models.api import build
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import leaves, unflatten
from repro_torch.train import data as pt_data
from repro_torch.train import optimizer as pt_opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import (clip_by_global_norm, global_norm,
                                       make_train_step)

ARCHS = ["qwen3-4b", "llama3.2-3b", "qwen2-moe-a2.7b", "mamba2-1.3b",
         "zamba2-7b", "whisper-medium"]
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def _cfgs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (jx_get_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _params(jcfg, seed=0):
    jp = jx_init(jx_build(jcfg).decls, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


# weights drawn N(0, 1 / fan-in): the leading axes a weight contracts (after
# the layer axis of a stacked leaf)
FAN_IN_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1,
               "w_down": 1, "out": 1, "in_proj": 1, "out_proj": 1,
               "conv_w": 1}
STACKS = ("layers", "mamba", "encoder", "decoder")
# seeded stacks whose f32 gradients JAX itself cannot hold to GRAD_REL: a
# relative 1e-7 perturbation of zamba2's JAX-initialised smoke parameters
# moves JAX's own A_log gradient by 1.1e-4 of its largest entry; whisper's
# moves its own logits by 8e-5 (tests/test_torch_encdec.py)
CHAOTIC = ("zamba2-7b", "whisper-medium")


def scaled_params(jcfg, seed=0):
    """The config's parameter tree drawn in numpy, each weight
    N(0, 1 / its whole fan-in), norm scales and ``D`` U(0.5, 1.5), zero-
    initialised leaves N(0, 0.1), ``normal`` leaves N(0, their scale); as
    JAX arrays and port tensors."""
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
    tree = draw(jx_build(jcfg).decls)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu")


def _batch(cfg, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["audio_embeds"] = rng.normal(
            0, 1, (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _port_grads(model, params, batch):
    p_l = [p.clone().requires_grad_() for p in leaves(params)]
    loss, metrics = model.loss_fn(unflatten(params, p_l),
                                  {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    grads = torch.autograd.grad(loss, p_l, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = (scaled_params if arch in CHAOTIC else _params)(jcfg)
    batch = _batch(cfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        jx_build(jcfg).loss_fn, has_aux=True)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_grads(build(cfg), tp, batch)
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    assert abs(float(metrics["loss"]) - float(jmet["loss"])) <= \
        LOSS_REL * abs(float(jmet["loss"]))
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(jgrads)]
    jl = jax.tree.leaves(jgrads)
    assert len(grads) == len(jl)
    for name, g, w in zip(names, grads, jl):
        assert g is not None, f"{arch}: {name} gets no gradient"
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err, top = np.abs(g.numpy() - w).max(), np.abs(w).max()
        assert err <= GRAD_REL * top, \
            f"{arch} {name}: max |diff| {err} > {GRAD_REL} x {top}"


def test_moe_aux_carries_a_gradient_as_in_jax():
    """The load-balancing term reaches the router through the router's
    probabilities (``me``), in both packages."""
    jcfg, cfg = _cfgs("qwen2-moe-a2.7b")
    jp, tp = _params(jcfg)
    batch = _batch(cfg)
    jaux = jax.grad(lambda p: jx_build(jcfg).loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()})[1]["aux"])(jp)
    p_l = [p.clone().requires_grad_() for p in leaves(tp)]
    _, metrics = build(cfg).loss_fn(unflatten(tp, p_l),
                                    {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    grads = torch.autograd.grad(metrics["aux"], p_l, allow_unused=True)
    for name, g, w in zip([jax.tree_util.keystr(k) for k, _ in
                           jax.tree_util.tree_leaves_with_path(jaux)],
                          grads, jax.tree.leaves(jaux)):
        w = np.asarray(w)
        if "router" in name:
            assert g is not None and np.abs(w).max() > 0
        if g is None:
            assert not np.any(w), name
            continue
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * np.abs(w).max() \
            + 1e-12, name


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-moe-a2.7b",
                                  "zamba2-7b", "whisper-medium"])
def test_remat_modes_give_bit_equal_gradients(arch):
    jcfg, _ = _cfgs(arch)
    _, tp = _params(jcfg)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = get_config(arch, smoke=True).replace(compute_dtype="float32",
                                                   remat=remat)
        loss, _, grads = _port_grads(build(cfg), tp, _batch(cfg))
        out[remat] = (loss, grads)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for g, w in zip(out[remat][1], out["none"][1]):
            assert torch.equal(g, w), remat


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
@pytest.mark.parametrize("chunk", [0, 8, 12], ids=["whole", "chunk8",
                                                   "indivisible"])
def test_lm_loss_matches_jax(chunk, masked):
    """``loss_chunk`` 8 over S = 32 runs four checkpointed chunks; 12 does
    not divide 32, so both packages take the whole sequence."""
    jcfg, cfg = _cfgs("llama3.2-3b", loss_chunk=chunk, tie_embeddings=True)
    rng = np.random.default_rng(5)
    h = rng.normal(0, 1, (2, 32, cfg.d_model)).astype(np.float32)
    tok = rng.normal(0, 1, (cfg.vocab_size, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    mask = (rng.uniform(size=(2, 32)) > 0.3).astype(np.float32) \
        if masked else None

    def jx_loss(h, tok):
        return JL.lm_loss({"tok": tok}, h, jnp.asarray(tgt), jcfg,
                          None if mask is None else jnp.asarray(mask))
    want, (jgh, jgt) = jax.value_and_grad(jx_loss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(tok))
    th = torch.from_numpy(h).requires_grad_()
    tt = torch.from_numpy(tok).requires_grad_()
    got = L.lm_loss({"tok": tt}, th, torch.from_numpy(tgt), cfg,
                    None if mask is None else torch.from_numpy(mask))
    gh, gt = torch.autograd.grad(got, (th, tt))
    got = got.detach()
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))
    for g, w in ((gh, jgh), (gt, jgt)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * np.abs(w).max()


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 3, (3, 7, 50)).astype(np.float32)
    tgt = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(tgt))
    got = L.softmax_xent(torch.from_numpy(logits), torch.from_numpy(tgt))
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))


@pytest.mark.parametrize("grad_accum,clip", [(1, 1.0), (2, 1.0), (1, 0.0)],
                         ids=["clipped", "accum2", "unclipped"])
def test_four_train_steps_match_jax(grad_accum, clip):
    jcfg, cfg = _cfgs("llama3.2-3b", grad_clip=clip)
    jp, tp = _params(jcfg)
    jstep, jopt = jx_make_train_step(jx_build(jcfg), jcfg,
                                     grad_accum=grad_accum)
    jstate = jopt.init(jp)
    step, opt = make_train_step(build(cfg), cfg, grad_accum=grad_accum)
    state = opt.init(tp)
    for i in range(4):
        batch = _batch(cfg, B=4, S=16, seed=10 + i)
        jp, jstate, jm = jstep(jp, jstate,
                               {k: jnp.asarray(v) for k, v in batch.items()})
        tp2, state2, m = step(tp, state, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        assert tp2 is tp and state2 is state       # updated in place
        for key in ("loss", "grad_norm"):
            want = float(jm[key])
            assert abs(float(m[key]) - want) <= 1e-4 * abs(want), (i, key)
    assert state["count"] == int(jstate["count"]) == 4
    for t, w in zip(leaves(tp), jax.tree.leaves(jp)):
        w = np.asarray(w)
        assert np.abs(t.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def _tree(seed, dtype=np.float32):
    """A small parameter-shaped tree: stacked 3-d, 2-d (one factored, one
    with a unit axis) and 1-d leaves."""
    rng = np.random.default_rng(seed)
    return {"layers": {"w": rng.normal(0, 1, (2, 6, 5)).astype(dtype),
                       "scale": rng.normal(0, 1, (2, 5)).astype(dtype)},
            "embed": {"tok": rng.normal(0, 1, (9, 4)).astype(dtype)},
            "col": rng.normal(0, 1, (7, 1)).astype(dtype),
            "bias": rng.normal(0, 1, (3,)).astype(dtype)}


OPTS = {"adamw": (lambda: jx_opt.make_adamw(weight_decay=0.1),
                  lambda: pt_opt.make_adamw(weight_decay=0.1)),
        "adafactor": (jx_opt.make_adafactor, pt_opt.make_adafactor),
        "sgd": (jx_opt.make_sgd, pt_opt.make_sgd),
        "lion": (lambda: jx_opt.make_lion(weight_decay=0.1),
                 lambda: pt_opt.make_lion(weight_decay=0.1))}


def _t(tree):
    return params_from_jax(tree, "cpu")


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_updates_match_jax(name):
    """Three in-place updates from the same parameters and gradients: the
    new parameters (JAX's params + updates) and the state within 1e-6 of
    JAX's."""
    jmake, tmake = OPTS[name]
    jo, to = jmake(), tmake()
    params = _tree(0)
    jstate, tstate = jo.init(jax.tree.map(jnp.asarray, params)), \
        to.init(_t(params))
    for i in range(3):
        grads = _tree(1 + i)
        ju, jstate = jo.update(jax.tree.map(jnp.asarray, grads), jstate,
                               jax.tree.map(jnp.asarray, params), 1e-2)
        tparams = _t(params)
        to.update_(leaves(_t(grads)), tstate, tparams, 1e-2)
        params = jax.tree.map(lambda p, u: p + np.asarray(u), params, ju)
        for a, b in zip(leaves(tparams), jax.tree.leaves(params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)
    js = [x for x in jax.tree.leaves(jstate) if np.ndim(x)]
    ts = [x for x in leaves(tstate) if isinstance(x, torch.Tensor)]
    assert len(js) == len(ts)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)
    assert tstate["count"] == int(jstate["count"]) == 3


def test_in_place_update_is_bit_equal_to_functional(monkeypatch):
    """AdamW's ``update_`` writes its functional ``update``'s numbers into
    the state and the parameters, bit for bit, and frees every gradient;
    a slice smaller than a leaf (``SLICE``) changes nothing."""
    monkeypatch.setattr(pt_opt, "SLICE", 7)
    to = OPTS["adamw"][1]()
    params = _t(_tree(0))
    live = [p.clone() for p in leaves(params)]
    live_params = unflatten(params, live)
    state, live_state = to.init(params), to.init(live_params)
    for i in range(3):
        grads = _t(_tree(1 + i))
        upd, state = to.update(grads, state, params, 1e-2)
        params = unflatten(params, [p + u for p, u in
                                    zip(leaves(params), leaves(upd))])
        g_list = leaves(grads)
        to.update_(g_list, live_state, live_params, 1e-2)
        assert all(g is None for g in g_list)
    for a, b in zip(leaves(live_params), leaves(params)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(live_state), leaves(state)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_in_place_update_slices_and_frees_gradients(name, monkeypatch):
    """``update_`` over flat slices smaller than a leaf (``SLICE`` = 7)
    writes what it writes over whole leaves, bit for bit, and frees every
    gradient it was given."""
    to = OPTS[name][1]()
    runs = []
    for slice_ in (pt_opt.SLICE, 7):
        monkeypatch.setattr(pt_opt, "SLICE", slice_)
        params = _t(_tree(0))
        state = to.init(params)
        for i in range(3):
            g_list = leaves(_t(_tree(1 + i)))
            to.update_(g_list, state, params, 1e-2)
            assert all(g is None for g in g_list)
        runs.append((leaves(params), leaves(state)))
    (p_a, s_a), (p_b, s_b) = runs
    assert all(torch.equal(a, b) for a, b in zip(p_a, p_b))
    assert len(s_a) == len(s_b)
    for a, b in zip(s_a, s_b):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)


def test_get_optimizer_follows_the_config():
    for name in OPTS:
        cfg = SimpleNamespace(optimizer=name, weight_decay=0.0)
        assert pt_opt.get_optimizer(cfg).name == jx_opt.get_optimizer(cfg).name
    with pytest.raises(ValueError, match="unknown optimizer"):
        pt_opt.get_optimizer(SimpleNamespace(optimizer="nope"))


def test_global_norm_and_clip_match_jax():
    from repro.train import trainer as jx_trainer
    grads = _tree(3)
    jn = jx_trainer.global_norm(jax.tree.map(jnp.asarray, grads))
    jc, _ = jx_trainer.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                           1.0)
    g_list = leaves(_t(grads))
    assert abs(float(global_norm(g_list)) - float(jn)) <= 1e-6 * float(jn)
    clipped, n = clip_by_global_norm(g_list, 1.0)
    assert abs(float(n) - float(jn)) <= 1e-6 * float(jn)
    for a, b in zip(clipped, jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                   rtol=1e-6)


@pytest.mark.parametrize("workers", [0, 2])
def test_token_batches_are_jax_bit_for_bit(workers):
    mine = pt_data.PrefetchLoader(pt_data.SyntheticTokens(
        300, 3, 17, seed=4, n_batches=5), workers=workers)
    theirs = jx_data.PrefetchLoader(jx_data.SyntheticTokens(
        300, 3, 17, seed=4, n_batches=5), workers=workers)
    got, want = list(mine), list(theirs)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k])
    batch = pt_data.to_device(got[0], "cpu")
    assert batch["tokens"].dtype == torch.int32
    assert np.array_equal(batch["targets"].numpy(), want[0]["targets"])


def test_launcher_lm_path_matches_jax_checkpoints(tmp_path, capsys):
    """``--arch qwen3-4b --smoke --steps 3``: JAX's lines with finite
    losses, three saves (every step: 3 // 3) of which keep 2 are left, the
    same committed steps and leaf names as the JAX launcher's run."""
    argv = ["--arch", "qwen3-4b", "--smoke", "--steps", "3",
            "--ckpt-dir", str(tmp_path / "port")]
    assert main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("  step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "[result] 3 steps in" in out and "checkpoints=3" in out

    args = SimpleNamespace(arch="qwen3-4b", smoke=True, steps=3, seed=0,
                           batch=8, seq=128, workers=2,
                           ckpt_dir=str(tmp_path / "jax"))
    assert jx_launch.run_lm(args) == 0
    assert "checkpoints=3" in capsys.readouterr().out
    mine, theirs = CheckpointManager(tmp_path / "port"), JxCkpt(tmp_path /
                                                                "jax")
    assert mine.all_steps() == theirs.all_steps() == [2, 3]
    want = theirs.read_manifest(3)["leaves"]
    got = mine.read_manifest(3)["leaves"]
    assert got.keys() == want.keys()
    for name in want:
        assert got[name]["shape"] == want[name]["shape"], name


def test_launcher_layers_cuts_the_stack(tmp_path, capsys):
    """``--layers 1``: the run trains and checkpoints a one-layer stack at
    the configuration's width; every other leaf keeps its shape."""
    from repro_torch.launch.train import build_parser, run_lm
    argv = ["--arch", "llama3.2-3b", "--smoke", "--steps", "2", "--device",
            "cpu", "--ckpt-dir", str(tmp_path)]
    full = run_lm(build_parser().parse_args(argv))
    cut = run_lm(build_parser().parse_args(argv + ["--layers", "1"]))
    capsys.readouterr()
    assert len(cut["history"]) == 2
    assert all(np.isfinite(h[1]) for h in cut["history"])
    for a, b in zip(leaves(cut["state"]["params"]["layers"]),
                    leaves(full["state"]["params"]["layers"])):
        assert a.shape == (1, *b.shape[1:])
    assert cut["state"]["params"]["embed"]["tok"].shape == \
        full["state"]["params"]["embed"]["tok"].shape


def test_lm_training_on_cuda_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        main(["--arch", "qwen3-4b", "--smoke", "--steps", "1",
              "--ckpt-dir", str(tmp_path)])


def test_step_with_a_grad_transform_and_an_unused_leaf():
    """The ``grad_transform`` hook sees the gradient tree; a leaf the loss
    does not reach gets a zero gradient (``jax.grad``'s), so its AdamW
    update is 0."""
    _, cfg = _cfgs("llama3.2-3b")
    model = build(cfg)
    jcfg, _ = _cfgs("llama3.2-3b")
    _, tp = _params(jcfg)
    tp["unused"] = torch.ones(3)
    seen = []

    def transform(tree):
        seen.append(sorted(tree))
        return tree
    model = dataclasses.replace(model, loss_fn=lambda p, b: build(
        cfg).loss_fn({k: v for k, v in p.items() if k != "unused"}, b))
    step, opt = make_train_step(model, cfg, grad_transform=transform)
    state = opt.init(tp)
    batch = _batch(cfg, B=2, S=8)
    step(tp, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert seen == [sorted(tp)]
    assert torch.equal(tp["unused"], torch.ones(3))
