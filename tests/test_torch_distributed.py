"""The port's distributed shims over the host-simulated mesh against the JAX
package's ``shard_map`` programs on 8 forced host devices.

JAX's side runs once, in a subprocess (a process's device count is fixed
at its first JAX call), as ``tests/test_distributed.py`` runs it, and
writes its outputs to an ``.npz``; the port's side feeds the same numpy
inputs to ``repro_torch`` in this process:

  * ``flash_decode_attention`` against JAX's, within 1e-6 at the inputs of
    ``tests/test_distributed.py::test_flash_decode_shardmap_matches_ref``,
    and at positions on the slice edges no further than 1e-6 beyond JAX's
    own distance from the exact attention;
  * ``compressed_psum_int8`` over 8 members, bit-equal to every member's
    result of JAX's ``shard_map`` over a ``pod`` axis of 8;
  * ``make_crosspod_grad_transform`` on a (2, 4) ``("pod", "data")``
    mesh, bit-equal;
  * the GPipe pipeline (``make_pipeline_fn``, 4 stages, 8 microbatches,
    the inputs of ``test_pipeline_parallel_matches_sequential``) within 1e-6
    of JAX's, bit-equal to the port's sequential stack run on
    each microbatch, and its gradient within 1e-6 of the sequential
    stack's;
  * the MoE layer under the sharding context of 8 data shards (tokens
    grouped by ``ctx_dp_size``, the capacity per group) within 1e-5 of
    JAX's ``moe_mlp`` jitted under its context on an 8-device mesh.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed.collectives import flash_decode_attention
from repro_torch.configs import get_config
from repro_torch.distributed.pp import make_pipeline_fn, split_microbatches
from repro_torch.distributed.sharding import shard_ctx
from repro_torch.launch.mesh import AbstractMesh, HostSimMesh
from repro_torch.models.moe import moe_mlp
from repro_torch.train.compression import (compressed_psum_int8,
                                           make_crosspod_grad_transform)

SRC = str(Path(__file__).resolve().parents[1] / "src")
S, M, MB, D = 4, 8, 4, 16            # stages, microbatches, rows, width


def inputs():
    rng = np.random.default_rng(0)
    B, T, H, Dh = 2, 64, 4, 32
    fd = {"q": rng.normal(0, 1, (B, H, Dh)), "k": rng.normal(0, 1, (B, T, H, Dh)),
          "v": rng.normal(0, 1, (B, T, H, Dh)), "pos": np.array([17, 63])}
    rng = np.random.default_rng(1)
    B = 6                               # positions on slice edges: 8 of 8
    fd2 = {"q": rng.normal(0, 1, (B, H, Dh)), "k": rng.normal(0, 1, (B, T, H, Dh)),
           "v": rng.normal(0, 1, (B, T, H, Dh)),
           "pos": np.array([0, 7, 8, 31, 32, 63])}
    rng = np.random.default_rng(2)
    return {**{f"fd_{k}": v.astype(np.int32 if k == "pos" else np.float32)
               for k, v in fd.items()},
            **{f"fd2_{k}": v.astype(np.int32 if k == "pos" else np.float32)
               for k, v in fd2.items()},
            "cp_x": rng.normal(0, 1, (8, 128)).astype(np.float32),
            "cp_ties": (rng.integers(-3, 4, (8, 128)) * 0.25).astype(np.float32),
            "xp_w": rng.normal(0, 1, (16, 12)).astype(np.float32),
            "xp_b": rng.normal(0, 1, (12,)).astype(np.float32),
            "moe_x": rng.normal(0, 1, (4, 64, 64)).astype(np.float32),
            **pipeline_inputs()}


def pipeline_inputs():
    """``tests/test_distributed.py::test_pipeline_parallel_matches_sequential``'s
    seeded weights and batch."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, (S, D, D)).astype(np.float32)
    return {"pp_w": w, "pp_x": rng.normal(0, 1, (M * MB, D)).astype(np.float32)}


JAX_SIDE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.distributed.collectives import flash_decode_attention
from repro.distributed.pp import make_pipeline_fn, split_microbatches
from repro.train.compression import (compressed_psum_int8,
                                     make_crosspod_grad_transform)
inp = dict(np.load(sys.argv[1]))
out = {}
mesh = jax.make_mesh((8,), ("model",))
fn = jax.jit(flash_decode_attention(mesh, "model"))
for c in ("fd", "fd2"):
    out[c] = np.asarray(fn(*(jnp.asarray(inp[f"{c}_{k}"])
                             for k in ("q", "k", "v", "pos"))))
mesh = jax.make_mesh((8,), ("pod",))
cp = shard_map(lambda t: compressed_psum_int8(t, "pod"), mesh=mesh,
               in_specs=P("pod", None), out_specs=P("pod", None),
               check_rep=False)
for c in ("cp_x", "cp_ties"):
    out[c] = np.asarray(jax.jit(cp)(jnp.asarray(inp[c])))
mesh = jax.make_mesh((2, 4), ("pod", "data"))
tr = make_crosspod_grad_transform(mesh)
got = tr({"w": jnp.asarray(inp["xp_w"]), "b": jnp.asarray(inp["xp_b"])})
out["xp_w"], out["xp_b"] = np.asarray(got["w"]), np.asarray(got["b"])
mesh = jax.make_mesh((4,), ("stage",))
pipe = make_pipeline_fn(lambda w, x: jnp.tanh(x @ w), 4, 8, mesh)
xs = split_microbatches(jnp.asarray(inp["pp_x"]), 8)
out["pp"] = np.asarray(jax.jit(pipe)(jnp.asarray(inp["pp_w"]), xs))
from jax.sharding import AxisType
from repro.configs import get_config
from repro.distributed.sharding import shard_ctx
from repro.models.api import build
from repro.models.moe import moe_mlp
from repro.models.params import init_params
cfg = get_config("qwen2-moe-a2.7b", smoke=True).replace(
    compute_dtype="float32")
lp = jax.tree.map(lambda a: a[0], init_params(
    build(cfg).decls, jax.random.PRNGKey(0))["layers"]["moe"])
mesh = jax.make_mesh((8, 1), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
for k, v in jax.tree_util.tree_leaves_with_path(lp):
    out["moe_p" + jax.tree_util.keystr(k)] = np.asarray(v)
with shard_ctx(cfg, mesh):
    y, aux = jax.jit(lambda lp, x: moe_mlp(lp, x, cfg))(
        lp, jnp.asarray(inp["moe_x"]))
out["moe_y"], out["moe_aux"] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[2], **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_side")
    np.savez(d / "in.npz", **inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SIDE),
                        str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, timeout=360, env=env)
    assert r.returncode == 0 and "JAX_SIDE_OK" in r.stdout, \
        f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
    return dict(np.load(d / "out.npz"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _masked_attention_f64(inp, case):
    q, k, v, pos = (_t(inp[f"{case}_{n}"]).double()
                    for n in ("q", "k", "v", "pos"))
    s = torch.einsum("bhe,bthe->bht", q, k)
    mask = torch.arange(k.shape[1])[None, :] <= pos[:, None]
    s = torch.where(mask[:, None, :], s, torch.full((), -1e30,
                                                    dtype=s.dtype))
    return torch.einsum("bht,bthe->bhe", torch.softmax(s, -1), v).numpy()


@pytest.mark.parametrize("case", ["fd", "fd2"])
def test_flash_decode_matches_jax(jax_out, case):
    """``fd`` (JAX's own test inputs): within 1e-6 of JAX's.  ``fd2``
    (positions on the slice edges, where both packages' f32 sums lie up to
    2.3e-6 from the exact attention): each element no further from the
    exact attention in f64 than JAX's is, plus 1e-6."""
    inp = inputs()
    fn = flash_decode_attention(HostSimMesh(8, "model"), "model")
    got = fn(*(_t(inp[f"{case}_{k}"]) for k in ("q", "k", "v", "pos")))
    ref = _masked_attention_f64(inp, case)
    if case == "fd":
        np.testing.assert_allclose(got.numpy(), jax_out[case], rtol=0,
                                   atol=1e-6)
    else:
        excess = np.abs(got.numpy() - ref) - np.abs(jax_out[case] - ref)
        assert excess.max() <= 1e-6, excess.max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_flash_decode_refuses_a_cache_that_does_not_split():
    fn = flash_decode_attention(HostSimMesh(8, "model"), "model")
    with pytest.raises(ValueError, match="does not split"):
        fn(torch.zeros(1, 2, 4), torch.zeros(1, 12, 2, 4),
           torch.zeros(1, 12, 2, 4), torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("case", ["cp_x", "cp_ties"])
def test_compressed_psum_int8_bit_equal_to_every_member(jax_out, case):
    x = inputs()[case]
    got = compressed_psum_int8([_t(x[i:i + 1]) for i in range(8)],
                               HostSimMesh(8, "pod")).numpy()
    for i in range(8):
        assert np.array_equal(got.view(np.uint32),
                              jax_out[case][i:i + 1].view(np.uint32)), i


def test_compressed_psum_int8_refuses_a_device_mesh_and_a_wrong_count():
    xs = [torch.ones(3)] * 2
    with pytest.raises(NotImplementedError):
        compressed_psum_int8(xs, AbstractMesh((2,), ("pod",)))
    with pytest.raises(ValueError):
        compressed_psum_int8(xs, HostSimMesh(4, "pod"))


def test_crosspod_transform_bit_equal(jax_out):
    inp = inputs()
    tr = make_crosspod_grad_transform(AbstractMesh((2, 4), ("pod", "data")))
    got = tr({"w": _t(inp["xp_w"]), "b": _t(inp["xp_b"])})
    for k in ("w", "b"):
        assert np.array_equal(got[k].numpy().view(np.uint32),
                              jax_out[f"xp_{k}"].view(np.uint32)), k


def _layer(w, x):
    return torch.tanh(x @ w)


def _pipeline_and_sequence(w, x):
    pipe = make_pipeline_fn(_layer, S, M, HostSimMesh(S, "stage"))
    got = pipe(w, split_microbatches(x, M))
    seq = []
    for mb in split_microbatches(x, M):
        for s in range(S):
            mb = _layer(w[s], mb)
        seq.append(mb)
    return got, torch.stack(seq)


def test_pipeline_matches_jax_and_the_sequential_stack(jax_out):
    inp = inputs()
    got, seq = _pipeline_and_sequence(_t(inp["pp_w"]), _t(inp["pp_x"]))
    assert got.shape == (M, MB, D)
    np.testing.assert_allclose(got.numpy(), jax_out["pp"], rtol=0, atol=1e-6)
    assert torch.equal(got, seq)


def test_pipeline_gradient_matches_the_sequential_stack():
    inp = inputs()
    grads = []
    for k in range(2):
        w = _t(inp["pp_w"]).requires_grad_()
        x = _t(inp["pp_x"]).requires_grad_()
        out = _pipeline_and_sequence(w, x)[k]
        gw, gx = torch.autograd.grad((out ** 2).sum(), (w, x))
        grads.append((gw, gx))
    for a, b in zip(*grads):
        assert float(a.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_pipeline_takes_only_a_host_simulated_stage_axis():
    """A device-free ``AbstractMesh`` holds no stage, and a host-simulated
    mesh needs the stage axis (the group form: test_torch_group_pipeline)."""
    with pytest.raises(NotImplementedError, match="HostSimMesh or a GroupMesh"):
        make_pipeline_fn(_layer, S, M, AbstractMesh((S,), ("stage",)))
    with pytest.raises(ValueError):
        make_pipeline_fn(_layer, S, M, HostSimMesh(S, "part"))


def test_moe_groups_tokens_by_the_data_shards_as_jax(jax_out):
    cfg = get_config("qwen2-moe-a2.7b", smoke=True).replace(
        compute_dtype="float32")
    lp = {}
    for k, v in jax_out.items():
        if k.startswith("moe_p"):
            keys = [p.strip("[]'") for p in k[5:].split("][")]
            d = lp
            for p in keys[:-1]:
                d = d.setdefault(p, {})
            d[keys[-1]] = _t(v)
    x = _t(inputs()["moe_x"])
    with shard_ctx(cfg, AbstractMesh((8, 1), ("data", "model"))):
        y, aux = moe_mlp(lp, x, cfg)
    np.testing.assert_allclose(y.numpy(), jax_out["moe_y"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jax_out["moe_aux"]),
                               rtol=1e-6)
    # the grouping matters here: one group drops other tokens
    y1, _ = moe_mlp(lp, x, cfg)
    assert float((y1 - y).abs().max()) > 0.1
