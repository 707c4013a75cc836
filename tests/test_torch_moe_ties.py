"""The MoE's selections among exactly tied scores, against the JAX
package's.

JAX selects each token's top-k experts and each expert's top-C tokens with
``jax.lax.top_k``, which keeps the lower index among equal values; the
port's ``moe.top_k`` is a stable descending sort, and ``torch.topk``
promises no order among ties.  Ties are exact where rows are bit-equal
(padding, duplicate requests in a batch), so the input here is (2, 64, D)
whose rows are drawn from 4 distinct vectors: once an expert's capacity
binds, which of the tied tokens it keeps decides the output.

  * ``moe_mlp`` of the port against ``repro.models.moe.moe_mlp`` on one
    layer of JAX's ``init_params`` (f32) at capacity factors 1.25, 1.0 and
    0.5, within 1e-5 (``torch.topk`` read 0.537 at 1.25 and 1.045 at 0.5);
  * ``route``'s top-K among tied router probabilities (a router with
    equal columns) equal to ``jax.lax.top_k``'s;
  * ``top_k`` itself against ``jax.lax.top_k`` on integer-valued rows
    full of ties, -inf among them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models import moe as JM
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro_torch.configs import get_config
from repro_torch.models import moe as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import tree_map

ARCHS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]
ATOL = 1e-5
B, S, DISTINCT = 2, 64, 4


def _layer(arch, cf, seed=0):
    kw = dict(compute_dtype="float32", capacity_factor=cf)
    jcfg = jx_get_config(arch, smoke=True).replace(**kw)
    cfg = get_config(arch, smoke=True).replace(**kw)
    jp = jx_init(jx_build(jcfg).decls, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return (jcfg, cfg, jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            tree_map(lambda a: a[0], tp["layers"]["moe"]))


def _tied_x(d_model, seed=3):
    """(B, S, D) f32 whose rows are DISTINCT vectors, each repeated."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(0, 1, (DISTINCT, d_model)).astype(np.float32)
    return rows[rng.integers(0, DISTINCT, B * S)].reshape(B, S, d_model)


@pytest.mark.parametrize("cf", [1.25, 1.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_keeps_jax_order_among_tied_tokens(arch, cf):
    jcfg, cfg, jp, tp = _layer(arch, cf)
    x = _tied_x(cfg.d_model)
    assert M.capacity(cfg, B * S) < B * S     # the capacity binds
    jy, jaux = JM.moe_mlp(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        y, aux = M.moe_mlp(tp, torch.from_numpy(x), cfg)
    err = float(np.abs(y.numpy() - np.asarray(jy)).max())
    assert err <= ATOL, err
    assert abs(float(aux) - float(jaux)) <= ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_route_keeps_jax_order_among_tied_experts(arch):
    """A router whose columns are equal in pairs: every token's
    probabilities tie in pairs, and its top-K experts are JAX's."""
    jcfg, cfg, jp, tp = _layer(arch, 1.25)
    router = np.asarray(jp["router"]).copy()
    router[:, 1::2] = router[:, 0::2][:, :router[:, 1::2].shape[1]]
    x = _tied_x(cfg.d_model).reshape(B * S, -1)
    logits = jnp.asarray(x) @ jnp.asarray(router)
    E = cfg.num_experts_padded
    logits = jnp.where(jnp.arange(E) < cfg.num_experts, logits, -1e30)
    jw, ji = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.moe_top_k)
    with torch.no_grad():
        topi, w_te, _, _ = M.route(torch.from_numpy(x),
                                   torch.from_numpy(router), cfg)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    jw = np.asarray(jw / jnp.maximum(jw.sum(-1, keepdims=True), 1e-9))
    got = np.take_along_axis(w_te.numpy(), np.asarray(ji), axis=-1)
    np.testing.assert_allclose(got, jw, atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [1, 3, 8, 40])
def test_top_k_is_jax_top_k(k):
    rng = np.random.default_rng(k)
    x = rng.integers(0, 5, (6, 3, 64)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = -np.inf
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    v, i = M.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
