"""The port's CUDA kernels on the card, held against their plain versions.

Imports torch and the port only, so it runs where JAX is not installed:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test skips where no CUDA device is present."""
import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import gnn_config
from repro_torch.core.cache import FeatureCache
from repro_torch.core.feature_plane import DeviceFeaturePlane, HostFeaturePlane
from repro_torch.graph.synthetic import dataset_like
from repro_torch.kernels.gather.ops import cache_gather
from repro_torch.kernels.gather.ref import cache_gather_ref

pytestmark = pytest.mark.cuda

# (n, C, F): the JAX contract shapes, an odd bf16 width (2-byte words) and
# the full-width serving step
CASES = [(37, 16, 602), (5, 8, 300), (3, 4, 700), (100, 32, 602),
         (7, 8, 37), (4224, 98000, 100)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(n, C, F, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    cache = torch.from_numpy(rng.normal(0, 1, (C, F)).astype(np.float32))
    slots = torch.from_numpy(rng.integers(-1, C, n).astype(np.int32))
    return slots.to(device), cache.to(device, dtype)


@pytest.mark.parametrize("n,C,F", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_gather_kernel_matches_plain(card, n, C, F, dtype):
    slots, cache = _inputs(n, C, F, dtype, card)
    launches = cache_gather.launches
    out, miss = cache_gather(slots, cache)
    ref_out, ref_miss = cache_gather_ref(slots, cache)
    torch.cuda.synchronize()
    assert cache_gather.launches == launches + 1
    assert torch.equal(out, ref_out) and torch.equal(miss, ref_miss)


def test_cache_gather_kernel_unaligned_table(card):
    # a table that starts 4 bytes into its buffer takes the 4-byte path
    slots, cache = _inputs(64, 32, 100, torch.float32, card)
    buf = torch.empty(cache.numel() + 1, device=card)
    shifted = buf[1:].view(cache.shape)
    shifted.copy_(cache)
    out, miss = cache_gather(slots, shifted)
    ref_out, ref_miss = cache_gather_ref(slots, cache)
    torch.cuda.synchronize()
    assert torch.equal(out, ref_out) and torch.equal(miss, ref_miss)


def test_cache_gather_kernel_rejects_non_contiguous(card):
    slots, cache = _inputs(8, 16, 8, torch.float32, card)
    with pytest.raises(ValueError):
        cache_gather(slots, cache.t().contiguous().t())


def test_device_plane_on_card_matches_host_plane(card):
    g = dataset_like(gnn_config("products", smoke=True), seed=0)
    host = HostFeaturePlane(g, FeatureCache(g, 0.2, "fifo"))
    dev = DeviceFeaturePlane(g, FeatureCache(g, 0.2, "fifo"), device=card)
    rng = np.random.default_rng(2)
    launches = cache_gather.launches
    for _ in range(4):
        ids = rng.integers(0, g.num_nodes, 5000)       # two 4,096-row chunks
        assert np.array_equal(host.fetch(ids), dev.fetch(ids))
    assert cache_gather.launches - launches == dev.gather_dispatches == 8
    assert host.cache.stats == dev.cache.stats


# ---------------------------------------------------------------------------
# neighbor_agg (forward and backward) and gather_aggregate
# ---------------------------------------------------------------------------

# (Nd, Ns, fanout, D): a smoke hop, the odd D=602 and D=47 widths, a
# fanout above one warp, and the full-width hop 1 of graphsage-products
AGG_SHAPES = [(32, 64, 5, 24), (9, 20, 4, 602), (16, 40, 10, 47),
              (40, 90, 37, 100), (8192, 90112, 10, 256)]
AGG_MODES = ["mean", "sum", "weighted"]


def _agg_inputs(nd, ns, fan, d, device, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, ns, (nd, fan)).astype(np.int32)
    idx[1] = -1                                  # a row that is all padding
    arrs = (idx, rng.normal(0, 1, (ns, d)).astype(np.float32),
            rng.uniform(0, 1, (nd, fan)).astype(np.float32),
            rng.normal(0, 1, (nd, d)).astype(np.float32))
    return [torch.from_numpy(a).to(device) for a in arrs]


def _mode(mode, w):
    return ("sum", w) if mode == "weighted" else (mode, None)


def _close_to(got, want, rel):
    # |got - want| <= rel * (|want| + max|want|): atomics add in a
    # run-dependent order, so entries near zero are held to the largest
    bound = rel * (want.abs() + want.abs().max())
    assert bool(((got - want).abs() <= bound).all()), \
        float((got - want).abs().max())


@pytest.mark.parametrize("mode", AGG_MODES)
@pytest.mark.parametrize("shape", AGG_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_neighbor_agg_kernels_match_plain(card, shape, mode):
    from repro_torch.kernels.segment_agg.ops import (neighbor_agg,
                                                     neighbor_agg_backward)
    from repro_torch.kernels.segment_agg.ref import (neighbor_agg_bwd_ref,
                                                     neighbor_agg_ref)
    idx, h, w, dout = _agg_inputs(*shape, card)
    m, wt = _mode(mode, w)
    fwd, bwd = neighbor_agg.launches, neighbor_agg_backward.launches
    out = neighbor_agg(idx, h, m, wt)
    dh, dw = neighbor_agg_backward(idx, dout, h, m, wt)
    ref = neighbor_agg_ref(idx, h, m, wt)
    dh_r, dw_r = neighbor_agg_bwd_ref(idx, dout, h, m, wt)
    torch.cuda.synchronize()
    assert (neighbor_agg.launches - fwd, neighbor_agg_backward.launches
            - bwd) == (1, 1)
    # forward: sums in index order, as the plain version; 1e-5 for rounding
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    assert not out[1].any()
    _close_to(dh, dh_r, 1e-5)
    if wt is None:
        assert dw is None
    else:
        _close_to(dw, dw_r, 1e-5)
        assert not dw[idx < 0].any()


@pytest.mark.parametrize("mode", AGG_MODES)
def test_neighbor_agg_autograd_on_card(card, mode):
    from repro_torch.kernels.segment_agg.ops import neighbor_agg
    from repro_torch.kernels.segment_agg.ref import neighbor_agg_bwd_ref
    idx, h, w, dout = _agg_inputs(64, 200, 7, 47, card, seed=3)
    m, wt = _mode(mode, w)
    hh = h.clone().requires_grad_(True)
    wa = None if wt is None else wt.clone().requires_grad_(True)
    out = neighbor_agg(idx, hh, m, wa)
    grads = torch.autograd.grad(out, [hh] + ([wa] if wa is not None else []),
                                dout)
    dh_r, dw_r = neighbor_agg_bwd_ref(idx, dout, h, m, wt)
    _close_to(grads[0], dh_r, 1e-5)
    if wa is not None:
        _close_to(grads[1], dw_r, 1e-5)


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("ns,nd,fan,c,na,f", [
    (32, 16, 5, 24, 8, 100), (9, 9, 4, 8, 3, 602), (40, 12, 10, 16, 1, 47),
    (47367, 8192, 10, 98000, 64, 100)])
def test_gather_aggregate_kernel_matches_plain(card, ns, nd, fan, c, na, f,
                                               mode):
    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.kernels.fused_gather_agg.ref import gather_aggregate_ref
    rng = np.random.default_rng(7)
    enc = np.where(rng.random(ns) < 0.6, rng.integers(0, c, ns),
                   -rng.integers(1, na + 1, ns)).astype(np.int32)
    enc[-2:] = -1
    enc[0] = c + 3                               # clamps to C − 1
    idx = rng.integers(-1, ns, (nd, fan)).astype(np.int32)
    idx[1] = -1
    args = [torch.from_numpy(a).to(card) for a in (
        enc, idx, rng.normal(0, 1, (c, f)).astype(np.float32),
        rng.normal(0, 1, (na, f)).astype(np.float32))]
    launches = gather_aggregate.launches
    h, a = gather_aggregate(*args, mode=mode)
    h_r, a_r = gather_aggregate_ref(*args, mode=mode)
    torch.cuda.synchronize()
    assert gather_aggregate.launches == launches + 1
    assert torch.equal(h, h_r)                   # copies: bit-exact
    torch.testing.assert_close(a, a_r, atol=1e-5, rtol=1e-5)


def test_cuda_tensors_never_reach_the_plain_versions(card, monkeypatch):
    import repro_torch.kernels.fused_gather_agg.ops as fga
    import repro_torch.kernels.segment_agg.ops as sa

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    for mod, name in ((sa, "neighbor_agg_ref"), (sa, "neighbor_agg_bwd_ref"),
                      (fga, "gather_aggregate_ref")):
        monkeypatch.setattr(mod, name, refuse)
    idx, h, w, dout = _agg_inputs(12, 30, 4, 16, card)
    counts = (sa.neighbor_agg.launches, sa.neighbor_agg_backward.launches,
              fga.gather_aggregate.launches)
    hh = h.clone().requires_grad_(True)
    sa.neighbor_agg(idx, hh, "sum", w).backward(dout)
    enc = torch.arange(30, dtype=torch.int32, device=card)
    fga.gather_aggregate(enc, idx, h, h[:1].contiguous())
    torch.cuda.synchronize()
    assert (sa.neighbor_agg.launches - counts[0],
            sa.neighbor_agg_backward.launches - counts[1],
            fga.gather_aggregate.launches - counts[2]) == (1, 1, 1)
    with pytest.raises(TypeError):
        sa.neighbor_agg(idx, h.double())
    with pytest.raises(ValueError, match="contiguous"):
        sa.neighbor_agg(idx, h.t().contiguous().t())


def test_fused_train_step_on_card_matches_cpu(card):
    from repro_torch.core.a3gnn import A3GNNTrainer
    from repro_torch.kernels.segment_agg.ops import neighbor_agg
    cfg = gnn_config("products", smoke=True, fused_gather_agg=True,
                     sampling_device="device", model="gat")
    g = dataset_like(cfg, seed=0)
    on_card = A3GNNTrainer(g, cfg, seed=0, device=card)
    on_cpu = A3GNNTrainer(g, cfg, seed=0, device="cpu")
    launches = neighbor_agg.launches
    rc = on_card.run_epochs(1, max_steps_per_epoch=2)
    rh = on_cpu.run_epochs(1, max_steps_per_epoch=2)
    assert neighbor_agg.launches - launches == 2 * cfg.num_layers
    np.testing.assert_allclose(rc.stats.losses, rh.stats.losses, rtol=1e-4)
