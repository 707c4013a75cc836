"""The port's unfused GNN models and AdamW against the JAX package's, on
the same sampled batch and the same parameters (carried across by
``models/convert.py``).

Tolerances: logits within atol = rtol = 1e-5 (f32; the CPU matmuls of the
two frameworks sum in different orders); gradients within rtol 1e-4 of
``jax.value_and_grad`` of the reference loss (entries near zero within
1e-4 of the tensor's largest); parameters after three AdamW steps on the
same gradients within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gnn import gnn_config as jx_gnn_config
from repro.models.gnn import decls_gnn as jx_decls
from repro.models.gnn import gnn_forward as jx_forward
from repro.models.gnn import gnn_loss as jx_loss
from repro.models.params import init_params as jx_init
from repro.train.optimizer import make_adamw as jx_adamw
from repro_torch.configs.gnn import gnn_config
from repro_torch.core.sampling import NeighborSampler
from repro_torch.graph.batch import batch_device_arrays
from repro_torch.graph.synthetic import dataset_like
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.gnn import decls_gnn, gnn_forward, gnn_loss
from repro_torch.models.params import init_params, leaves, param_bytes
from repro_torch.train.optimizer import make_adamw

MODELS = ["graphsage", "gcn", "gat", "gin"]


@pytest.fixture(scope="module")
def batch():
    cfg = gnn_config("products", smoke=True)
    g = dataset_like(cfg, seed=0)
    seeds = np.flatnonzero(g.train_mask)[:cfg.batch_size]
    mb = NeighborSampler(g, cfg.fanout, seed=1).sample(seeds)
    mb.features = g.features[mb.input_ids]
    return batch_device_arrays(mb)


def _jax_params(model, seed=0):
    cfg = jx_gnn_config("products", smoke=True, model=model)
    return cfg, jx_init(jx_decls(cfg), jax.random.PRNGKey(seed))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_inputs(arrays):
    return (torch.from_numpy(arrays["features"]),
            [torch.from_numpy(i) for i in arrays["neigh_idxs"]],
            torch.from_numpy(arrays["labels"]))


@pytest.mark.parametrize("model", MODELS)
def test_forward_matches_jax(batch, model):
    jcfg, jp = _jax_params(model)
    cfg = gnn_config("products", smoke=True, model=model)
    ref = jx_forward(jp, jnp.asarray(batch["features"]),
                     [jnp.asarray(i) for i in batch["neigh_idxs"]], jcfg)
    feats, idxs, _ = _torch_inputs(batch)
    out = gnn_forward(params_from_jax(_np(jp), "cpu"), feats, idxs, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_loss_and_grads_match_jax(batch, model):
    jcfg, jp = _jax_params(model, seed=1)
    cfg = gnn_config("products", smoke=True, model=model)
    feats_j = jnp.asarray(batch["features"])
    idxs_j = [jnp.asarray(i) for i in batch["neigh_idxs"]]
    labels_j = jnp.asarray(batch["labels"])
    (loss_j, acc_j), g_j = jax.value_and_grad(
        lambda p: jx_loss(p, feats_j, idxs_j, labels_j, jcfg),
        has_aux=True)(jp)
    params = params_from_jax(_np(jp), "cpu")
    flat = [p.requires_grad_(True) for p in leaves(params)]
    feats, idxs, labels = _torch_inputs(batch)
    loss, acc = gnn_loss(params, feats, idxs, labels, cfg)
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    assert float(acc) == pytest.approx(float(acc_j))
    ref = [np.asarray(x) for x in jax.tree.leaves(g_j)]
    names = [f"{i}.{k}" for i, layer in enumerate(params["layers"])
             for k in sorted(layer)]
    for name, got, want in zip(names, grads, ref, strict=True):
        # rtol 1e-4, with entries near zero held to 1e-4 of the largest
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_adamw_three_steps_match_jax():
    jcfg, jp = _jax_params("gat", seed=2)
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(
        np.float32), _np(jp)) for _ in range(3)]
    jopt, topt = jx_adamw(), make_adamw()
    js, p_j = jopt.init(jp), jp
    params = params_from_jax(_np(jp), "cpu")
    ts = topt.init(params)
    for g in grads:
        u, js = jopt.update(jax.tree.map(jnp.asarray, g), js, p_j, jcfg.lr)
        p_j = jax.tree.map(lambda p, x: p + x, p_j, u)
        u_t, ts = topt.update(params_from_jax(g, "cpu"), ts, params, jcfg.lr)
        params = {"layers": [{k: v + u_t["layers"][i][k]
                              for k, v in layer.items()}
                             for i, layer in enumerate(params["layers"])]}
    assert ts["count"] == int(js["count"]) == 3
    got = params_to_numpy(params)
    for i, layer in enumerate(_np(p_j)["layers"]):
        for k, want in layer.items():
            np.testing.assert_allclose(got["layers"][i][k], want, atol=1e-6,
                                       rtol=0, err_msg=f"{i}.{k}")


@pytest.mark.parametrize("model", MODELS)
def test_decls_match_jax_shapes_and_init(model):
    jcfg, jp = _jax_params(model)
    cfg = gnn_config("products", smoke=True, model=model)
    decls = decls_gnn(cfg)
    params = init_params(decls, torch.Generator().manual_seed(0), "cpu")
    for tl, jl in zip(params["layers"], jp["layers"], strict=True):
        assert sorted(tl) == sorted(jl)
        for k in tl:
            assert tuple(tl[k].shape) == tuple(jl[k].shape)
            assert tl[k].dtype == torch.float32
            if k.startswith("b") or k == "eps":
                assert not tl[k].any()          # zeros, as in JAX
    assert param_bytes(decls) == sum(4 * x.size for x in jax.tree.leaves(jp))
    again = init_params(decls, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(params),
                                                 leaves(again)))
