"""The port's spec arithmetic (``repro_torch.distributed.sharding``, the
declarations' logical axes in ``models/params.py``, the optimizers'
``state_decls``, ``configs.applicable_shapes`` and ``Model.input_specs``)
against the JAX package's, for every LM arch on device-free meshes of the
production shapes — (16, 16) ``("data", "model")``, (2, 16, 16) ``("pod",
"data", "model")`` and (1, 1) — given to JAX as the ``FakeMesh`` stand-in
of ``tests/test_distributed.py`` and to the port both as that stand-in and
as its own ``AbstractMesh``.  Specs are compared normalised: trailing
``None``s dropped and a one-name tuple read as the name."""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import applicable_shapes as jx_applicable
from repro.configs import get_config as jx_get_config
from repro.distributed import sharding as jx_sh
from repro.models.api import build as jx_build
from repro.models.params import ParamDecl as JDecl
from repro.models.params import abstract_params as jx_abstract
from repro.models.params import logical_specs as jx_logical
from repro.models.params import param_count as jx_param_count
from repro.train import optimizer as jx_opt
from repro_torch.configs import applicable_shapes, get_config, list_archs
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import (AbstractMesh, axis_sizes, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.api import build
from repro_torch.models.params import (abstract_params, leaves,
                                       logical_specs, param_count)
from repro_torch.train import optimizer as pt_opt

ARCHS = [a for a in list_archs() if not a.startswith("graphsage")]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "host": ((1, 1), ("data", "model"))}
OPTIMIZERS = ("adamw", "adafactor", "sgd", "lion")


def fake_mesh(shape, names):
    class FakeMesh:
        axis_names = names

        class devices:
            pass
    FakeMesh.devices.shape = shape
    return FakeMesh()


def _norm(spec) -> tuple:
    out = [a[0] if isinstance(a, tuple) and len(a) == 1 else a
           for a in tuple(spec)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _jx_specs(tree):
    return [_norm(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _pt_specs(tree):
    return [s.normalized() for s in leaves(tree)]


def _jx_decls(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JDecl))


def _dt(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return jnp.dtype(dtype).name


def _same_decls(pt_tree, jx_tree):
    got, want = leaves(pt_tree), _jx_decls(jx_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.shape, g.axes, _dt(g.dtype), g.init, g.scale) == \
            (tuple(w.shape), tuple(w.axes), _dt(w.dtype), w.init, w.scale)


def test_production_and_host_meshes_have_jaxs_shapes():
    for multi, kind in ((False, "single"), (True, "multi")):
        m = make_production_mesh(multi_pod=multi)
        assert (m.sizes, m.axis_names) == MESHES[kind]
        assert m.size == (512 if multi else 256)
    h = make_host_mesh()
    assert (h.sizes, h.axis_names) == MESHES["host"]
    assert axis_sizes(fake_mesh((2, 16, 16), MESHES["multi"][1])) == \
        {"pod": 2, "data": 16, "model": 16}


def test_partition_spec_compares_as_jax_normalises():
    assert sh.P("a", None) == sh.P("a") and hash(sh.P("a", None)) == \
        hash(sh.P("a"))
    assert sh.P(("a",)) == sh.P("a") and sh.P(None, None) == sh.P()
    assert sh.P(("pod", "data"), None) != sh.P("data")
    assert sh.P("a", None) == ("a",) and len(sh.P("a", None)) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_declarations_carry_jaxs_axes(arch):
    cfg, jcfg = get_config(arch), jx_get_config(arch)
    model, jmodel = build(cfg), jx_build(jcfg)
    _same_decls(model.decls, jmodel.decls)
    assert param_count(model.decls) == jx_param_count(jmodel.decls)
    assert _pt_specs(logical_specs(model.decls)) == \
        _jx_specs(jx_logical(jmodel.decls))
    pdt = getattr(torch, cfg.param_dtype)
    got = abstract_params(model.decls, dtype_override=pdt)
    want = jax.tree.leaves(jx_abstract(jmodel.decls,
                                       dtype_override=jnp.dtype(
                                           jcfg.param_dtype)))
    assert [(tuple(t.shape), _dt(t.dtype)) for t in leaves(got)] == \
        [(tuple(s.shape), _dt(s.dtype)) for s in want]
    assert all(t.device.type == "meta" for t in leaves(got))
    for name in OPTIMIZERS:
        _same_decls(pt_opt.get_optimizer(cfg.replace(optimizer=name))
                    .state_decls(model.decls),
                    jx_opt.get_optimizer(jcfg.replace(optimizer=name))
                    .state_decls(jmodel.decls))


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_physical_specs_match_jax(arch, mesh_kind):
    shape, names = MESHES[mesh_kind]
    fm = fake_mesh(shape, names)
    cfg, jcfg = get_config(arch), jx_get_config(arch)
    model, jmodel = build(cfg), jx_build(jcfg)
    meshes = (fm, AbstractMesh(shape, names))
    for mesh in meshes:
        assert sh.make_rules(cfg, mesh) == jx_sh.make_rules(jcfg, fm)
        assert sh.dp_size(mesh) == jx_sh.dp_size(fm)
        assert sh.batch_spec(cfg, mesh).normalized() == \
            _norm(jx_sh.batch_spec(jcfg, fm))
    trees = [(model.decls, jmodel.decls)]
    for name in OPTIMIZERS:
        trees.append((pt_opt.get_optimizer(cfg.replace(optimizer=name))
                      .state_decls(model.decls),
                      jx_opt.get_optimizer(jcfg.replace(optimizer=name))
                      .state_decls(jmodel.decls)))
    for shp in applicable_shapes(cfg):
        trees.append((model.cache_decls(shp.global_batch, shp.seq_len),
                      jmodel.cache_decls(shp.global_batch, shp.seq_len)))
    for pt_tree, jx_tree in trees:
        want = _jx_specs(jx_sh.physical_specs(jx_tree, jcfg, fm))
        for mesh in meshes:
            assert _pt_specs(sh.physical_specs(pt_tree, cfg, mesh)) == want
    # logical specs resolve as JAX's do
    want = _jx_specs(jx_sh.physical_specs(jx_logical(jmodel.decls), jcfg, fm))
    assert _pt_specs(sh.physical_specs(logical_specs(model.decls), cfg,
                                       fm)) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), jx_get_config(arch)
    model, jmodel = build(cfg), jx_build(jcfg)
    shapes = applicable_shapes(cfg)
    assert [s.name for s in shapes] == [s.name for s in
                                        jx_applicable(jcfg)]
    for shp in shapes:
        got, want = model.input_specs(shp), jmodel.input_specs(shp)
        assert got["kind"] == want["kind"] == shp.kind
        assert sorted(got["batch"]) == sorted(want["batch"])
        for k, t in got["batch"].items():
            w = want["batch"][k]
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dt(t.dtype)) == (tuple(w.shape),
                                                      _dt(w.dtype)), k
            assert got["batch_specs"][k].normalized() == \
                _norm(want["batch_specs"][k]), k
        if shp.kind == "decode":
            _same_decls(got["cache_decls"], want["cache_decls"])
            assert [(tuple(t.shape), _dt(t.dtype))
                    for t in leaves(got["caches"])] == \
                [(tuple(s.shape), _dt(s.dtype))
                 for s in jax.tree.leaves(want["caches"])]


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_shard_ctx_sizes_match_jax(mesh_kind):
    shape, names = MESHES[mesh_kind]
    fm = fake_mesh(shape, names)
    cfg, jcfg = (get_config("qwen2-moe-a2.7b"),
                 jx_get_config("qwen2-moe-a2.7b"))
    assert sh.ctx_dp_size() == jx_sh.ctx_dp_size() == 1
    with sh.shard_ctx(cfg, AbstractMesh(shape, names)), \
            jx_sh.shard_ctx(jcfg, fm):
        assert sh.ctx_dp_size() == jx_sh.ctx_dp_size()
        for ax in ("pod", "data", "model", "stage"):
            assert sh.ctx_axis_size(ax) == jx_sh.ctx_axis_size(ax)
    assert sh.ctx_dp_size() == 1 and sh.ctx_axis_size("model") == 1
    x = torch.ones(3)
    assert sh.constrain(x, "dp") is x


def test_enforce_divisible_and_resolve_match_jax():
    fm = fake_mesh((16, 16), ("data", "model"))
    for spec, shape in ((("model", "data"), (51865, 1024)),
                        ((("pod", "data"), None), (32, 7)),
                        ((None, "model"), (3, 48)), (("data",), (8,))):
        assert sh.enforce_divisible(sh.P(*spec), shape, fm).normalized() == \
            _norm(jx_sh.enforce_divisible(JP(*spec), shape, fm))
    rules = jx_sh.make_rules(jx_get_config("minitron-8b"), fm)
    for spec in (("dp", None), (("dp", "tp"), "vocab"), ("kvseq", "nope")):
        assert sh.resolve_spec(sh.P(*spec), rules).normalized() == \
            _norm(jx_sh.resolve_spec(JP(*spec), rules))
