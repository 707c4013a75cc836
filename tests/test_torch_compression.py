"""The port's gradient compression (``repro_torch.train.compression``)
against the JAX package's (``src/repro/train/compression.py``) on the CPU,
bit for bit, from the same numpy inputs: int8 quantization, top-k
sparsification (ties and all-zero tensors among the inputs), error
feedback over trees, the analytic bytes of a quantized all-reduce, and
the port's twins of the JAX package's three behaviour tests
(``tests/test_train_substrate.py``).  The cross-member reductions over a
mesh are in ``tests/test_torch_distributed.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as jx_coll
from repro.train import compression as jx
from repro_torch.distributed.collectives import quantized_allreduce_bytes
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.train import compression as pt


def _inputs(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(0, 1, shape).astype(np.float32)
    if kind == "ties":               # few distinct magnitudes, both signs
        return (rng.integers(-3, 4, shape) * 0.5).astype(np.float32)
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "halves":             # x / scale lands on .5: round half even
        x = (rng.integers(-254, 255, shape) / 2.0).astype(np.float32)
        x.flat[0] = 127.0
        return x
    raise ValueError(kind)


KINDS = ["normal", "ties", "zeros", "halves"]
SHAPES = [(128, 64), (7,), (3, 5, 11)]


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a.reshape(-1).view(np.uint8),
                          b.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_dequantize_bit_equal(kind, shape):
    x = _inputs(kind, shape)
    jq, js = jx.quantize_int8(jnp.asarray(x))
    q, s = pt.quantize_int8(torch.from_numpy(x))
    _bits(q.numpy(), jq)
    _bits(s.numpy(), js)
    _bits(pt.dequantize_int8(q, s).numpy(), jx.dequantize_int8(jq, js))


@pytest.mark.parametrize("frac", [0.05, 0.25, 0.5, 1.0, 1e-6])
@pytest.mark.parametrize("kind", KINDS)
def test_topk_sparsify_densify_bit_equal(kind, frac):
    x = _inputs(kind, (32, 8), seed=3)
    jv, ji = jx.topk_sparsify(jnp.asarray(x), frac)
    v, i = pt.topk_sparsify(torch.from_numpy(x), frac)
    _bits(i.numpy(), ji)                   # ties: the lower index first
    _bits(v.numpy(), jv)
    _bits(pt.topk_densify(v, i, x.shape).numpy(),
          jx.topk_densify(jv, ji, x.shape))


def _tree(kind, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    base = {"w": _inputs(kind, (16, 12), seed), "b": _inputs(kind, (12,),
                                                             seed + 1),
            "layers": [rng.normal(0, 1, (4, 4)).astype(np.float32)]}
    return jax.tree.map(lambda a: a.astype(dtype), base)


def _pt_tree(tree):
    def one(a):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:       # exact: bf16 → f32 → bf16
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(one, tree)


def _tree_bits(got, want):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.float() if a.dtype == torch.bfloat16 else a
        b = np.asarray(b)
        b = b.astype(np.float32) if b.dtype == jnp.bfloat16 else b
        _bits(a.numpy(), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ["int8", "topk"])
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
def test_error_feedback_steps_bit_equal(scheme, kind, dtype):
    """Three error-feedback steps: the sent gradients and the residuals."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    jres = jx.ef_init(jax.tree.map(jnp.asarray, _tree(kind, 0)))
    res = pt.ef_init(_pt_tree(_tree(kind, 0)))
    _tree_bits(res, jres)
    for step in range(3):
        g = _tree(kind, 10 + step, jdt)
        jg = jax.tree.map(jnp.asarray, g)
        tg = _pt_tree(jax.tree.map(np.asarray, jg))
        if scheme == "int8":
            jsent, jres = jx.ef_compress_int8(jg, jres)
            sent, res = pt.ef_compress_int8(tg, res)
        else:
            jsent, jres = jx.ef_compress_topk(jg, jres, frac=0.1)
            sent, res = pt.ef_compress_topk(tg, res, frac=0.1)
        _tree_bits(sent, jsent)
        _tree_bits(res, jres)


@pytest.mark.parametrize("shape,n", [((1024, 4096), 256), ((7,), 2),
                                     ((3, 5), 512), ((1,), 1)])
@pytest.mark.parametrize("bits", [8, 4, 16])
def test_quantized_allreduce_bytes_equal(shape, n, bits):
    assert quantized_allreduce_bytes(shape, n, bits) == \
        jx_coll.quantized_allreduce_bytes(shape, n, bits)


def test_crosspod_transform_none_without_pod_axis():
    assert pt.make_crosspod_grad_transform(make_production_mesh()) is None
    assert pt.make_crosspod_grad_transform(
        make_production_mesh(multi_pod=True)) is not None
    assert pt.make_crosspod_grad_transform(
        AbstractMesh((4,), ("data",))) is None


# ---------------------------------------------------------------------------
# the JAX package's behaviour tests, on the port
# ---------------------------------------------------------------------------

def test_int8_quant_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (128, 64))
                         .astype(np.float32))
    q, s = pt.quantize_int8(x)
    err = (pt.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_error_feedback_unbiased_over_time():
    """With error feedback the accumulated sent signal tracks the
    accumulated true gradient (the residual stays bounded)."""
    rng = np.random.default_rng(123)
    g = torch.from_numpy(rng.normal(0, 1, (64,)).astype(np.float32))
    res = pt.ef_init({"w": g})
    total_true = np.zeros(64)
    total_sent = np.zeros(64)
    for i in range(30):
        gi = {"w": g * (1 + 0.1 * i)}
        sent, res = pt.ef_compress_topk(gi, res, frac=0.25)
        total_true += gi["w"].numpy()
        total_sent += sent["w"].numpy()
    resid = np.abs(res["w"].numpy())
    drift = np.abs(total_true - total_sent)
    np.testing.assert_allclose(drift, resid, atol=1e-3)   # EF identity
    last_scale = float(g.abs().max()) * (1 + 0.1 * 29)
    assert resid.max() < 1.5 * last_scale


def test_topk_roundtrip():
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (32, 8))
                         .astype(np.float32))
    vals, idx = pt.topk_sparsify(x, 0.5)
    dense = pt.topk_densify(vals, idx, x.shape)
    kept = dense != 0
    assert int(kept.sum()) == int(0.5 * x.numel())
    assert torch.equal(dense[kept], x[kept])
