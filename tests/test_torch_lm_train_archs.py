"""``Model.loss_fn`` and every gradient of the four LM archs that
``tests/test_torch_lm_train.py`` does not train, against
``jax.value_and_grad`` of the JAX package's, on the CPU at smoke size in
f32 (``compute_dtype="float32"``), from the same numpy inputs:

  * qwen2-vl-2b with ``vision_embeds`` over the first 16 rows and
    Qwen2-VL's grid ``positions (3, B, S)``, on ``scaled_params`` (JAX's
    initializer makes the seeded stack chaotic: a 1e-7 relative
    perturbation moves JAX's own worst gradient leaf 8.4e-5): the loss
    within 1e-6 of its size, each leaf's max |port - JAX| within 1e-5 of
    that leaf's max |JAX gradient|;
  * kimi-k2-1t-a32b (MoE with shared experts, JAX's initializer: the
    helper draws no router): leaves within 1e-4;
  * glm4-9b and minitron-8b on ``scaled_params``: leaves within 1e-5.  With
    JAX's initializer their worst leaves lie 1.2e-5 to 2.2e-5 of their
    largest entries from JAX's, and JAX's own f32 gradients lie as far
    (1.4e-5 to 1.7e-5) from JAX's f64 gradients of the same stack: the
    seeded stacks' f32 noise, not a difference of the port.

Every leaf gets a gradient in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro_torch.configs import get_config
from repro_torch.models.api import build
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import leaves, unflatten

# arch: (use scaled_params, loss rel, leaf rel)
CASES = {"qwen2-vl-2b": (True, 1e-6, 1e-5),
         "kimi-k2-1t-a32b": (False, 1e-5, 1e-4),
         "glm4-9b": (True, 1e-5, 1e-5),
         "minitron-8b": (True, 1e-5, 1e-5)}
VP, SIDE = 16, 4                  # vision prefix rows, its grid side

# weights drawn N(0, 1 / fan-in): the leading axes a weight contracts (after
# the layer axis of a stacked leaf)
FAN_IN_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1,
               "w_down": 1, "out": 1}
STACKS = ("layers",)


def scaled_params(jcfg, seed=0):
    """The config's parameter tree drawn in numpy: each weight N(0, 1 / its
    whole fan-in), norm scales U(0.5, 1.5), zero-initialised leaves
    N(0, 0.1), ``normal`` leaves N(0, their scale); as JAX arrays and port
    tensors (``tests/test_torch_lm_train.py``'s)."""
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


def jax_params(jcfg, seed=0):
    jp = jx_init(jx_build(jcfg).decls, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def grid_positions(B, S, vp, side):
    """(3, B, S) int32: a side × side patch grid over the first vp rows,
    then the text on all three streams from ``side`` on."""
    i = np.arange(S)
    t = np.where(i < vp, 0, side + i - vp)
    h = np.where(i < vp, i // side, t)
    w = np.where(i < vp, i % side, t)
    return np.broadcast_to(np.stack([t, h, w])[:, None], (3, B, S)
                           ).astype(np.int32).copy()


def batch(cfg, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.normal(0, 1, (B, VP, cfg.d_model)
                                          ).astype(np.float32)
        out["positions"] = grid_positions(B, S, VP, SIDE)
    return out


@pytest.mark.parametrize("arch", list(CASES))
def test_loss_and_every_gradient_match_jax(arch):
    scaled, loss_rel, leaf_rel = CASES[arch]
    jcfg = jx_get_config(arch, smoke=True).replace(compute_dtype="float32")
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    jp, tp = (scaled_params if scaled else jax_params)(jcfg)
    b = batch(cfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        jx_build(jcfg).loss_fn, has_aux=True)(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    p_l = [p.clone().requires_grad_() for p in leaves(tp)]
    loss, metrics = build(cfg).loss_fn(unflatten(tp, p_l),
                                       {k: torch.from_numpy(v)
                                        for k, v in b.items()})
    grads = torch.autograd.grad(loss, p_l, allow_unused=True)
    assert abs(float(loss) - float(jloss)) <= loss_rel * abs(float(jloss))
    assert abs(float(metrics["loss"]) - float(jmet["loss"])) <= \
        loss_rel * abs(float(jmet["loss"]))
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(jgrads)]
    jl = jax.tree.leaves(jgrads)
    assert len(grads) == len(jl)
    for name, g, w in zip(names, grads, jl):
        assert g is not None, f"{arch}: {name} gets no gradient"
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err, top = np.abs(g.numpy() - w).max(), np.abs(w).max()
        assert err <= leaf_rel * top, \
            f"{arch} {name}: max |diff| {err} > {leaf_rel} x {top}"
