"""The distributed shims and the dry-run's ``meta`` path of ``flash_attention``
on the card.

Imports torch and the port only, so it runs where JAX is not installed:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_shims.py

  * int8 quantization, top-k sparsification and both error-feedback
    schemes on CUDA tensors, bit-equal to the same calls on the CPU;
  * ``compressed_psum_int8`` over 8 host-simulated members and the
    cross-pod transform on the card, bit-equal to the CPU;
  * ``flash_decode_attention`` and a 4-stage pipeline on the card, within
    1e-5 of the CPU;
  * a CUDA ``flash_attention`` still launches its kernel (and counts it):
    only a ``meta`` tensor takes the plain version.

Every test skips where no CUDA device is present."""
import numpy as np
import pytest
import torch

from repro_torch.distributed.collectives import flash_decode_attention
from repro_torch.distributed.pp import make_pipeline_fn, split_microbatches
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch.mesh import AbstractMesh, HostSimMesh
from repro_torch.train import compression as C

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _x(shape, seed=0, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return torch.from_numpy((rng.integers(-3, 4, shape) * 0.5)
                                .astype(np.float32))
    if kind == "zeros":
        return torch.zeros(shape)
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
def test_quantize_and_topk_bit_equal_to_cpu(card, kind):
    x = _x((257, 33), kind=kind)
    for got, want in zip(C.quantize_int8(x.to(card)), C.quantize_int8(x)):
        _same(got, want)
    q, s = C.quantize_int8(x)
    _same(C.dequantize_int8(q.to(card), s.to(card)), C.dequantize_int8(q, s))
    for frac in (0.01, 0.25, 1.0):
        v, i = C.topk_sparsify(x.to(card), frac)
        wv, wi = C.topk_sparsify(x, frac)
        _same(i, wi)
        _same(v, wv)
        _same(C.topk_densify(v, i, x.shape), C.topk_densify(wv, wi, x.shape))


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_error_feedback_bit_equal_to_cpu(card, scheme):
    tree = {"w": _x((64, 48), 1), "b": _x((48,), 2).to(torch.bfloat16)}
    res = {"cpu": C.ef_init(tree),
           "card": C.ef_init({k: v.to(card) for k, v in tree.items()})}
    for step in range(3):
        g = {k: v * (1 + step) for k, v in tree.items()}
        out = {}
        for dev in ("cpu", "card"):
            gd = {k: v.to(card if dev == "card" else "cpu")
                  for k, v in g.items()}
            fn = (C.ef_compress_int8 if scheme == "int8" else
                  lambda a, r: C.ef_compress_topk(a, r, frac=0.1))
            out[dev], res[dev] = fn(gd, res[dev])
        for k in tree:
            _same(out["card"][k], out["cpu"][k])
            _same(res["card"][k], res["cpu"][k])


def test_compressed_psum_and_crosspod_bit_equal_to_cpu(card):
    xs = [_x((4, 1024), s) for s in range(8)]
    mesh = HostSimMesh(8, "pod")
    _same(C.compressed_psum_int8([x.to(card) for x in xs], mesh),
          C.compressed_psum_int8(xs, mesh))
    tr = C.make_crosspod_grad_transform(AbstractMesh((2, 16, 16),
                                                     ("pod", "data", "model")))
    g = {"w": _x((128, 64), 9)}
    _same(tr({"w": g["w"].to(card)})["w"], tr(g)["w"])


def test_flash_decode_and_pipeline_match_cpu(card):
    fn = flash_decode_attention(HostSimMesh(8, "model"), "model")
    q, k, v = _x((4, 8, 64), 3), _x((4, 512, 8, 64), 4), _x((4, 512, 8, 64), 5)
    pos = torch.tensor([0, 63, 64, 511], dtype=torch.int32)
    got = fn(q.to(card), k.to(card), v.to(card), pos.to(card))
    torch.testing.assert_close(got.cpu(), fn(q, k, v, pos), rtol=0,
                               atol=1e-5)
    w, x = _x((4, 32, 32), 6) * 0.3, _x((64, 32), 7)
    pipe = make_pipeline_fn(lambda p, h: torch.tanh(h @ p), 4, 8,
                            HostSimMesh(4, "stage"))
    got = pipe(w.to(card), split_microbatches(x.to(card), 8))
    torch.testing.assert_close(got.cpu(), pipe(w, split_microbatches(x, 8)),
                               rtol=0, atol=1e-5)


def test_cuda_flash_attention_still_launches_the_kernel(card):
    q = torch.randn(1, 128, 4, 64, device=card, dtype=torch.bfloat16)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.device.type == "cuda" and out.shape == q.shape
    qg = q.clone().requires_grad_()
    fa.flash_attention(qg, qg, qg).float().sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
