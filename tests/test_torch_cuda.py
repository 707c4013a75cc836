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
from repro_torch.kernels.reservoir.ops import chunked, layout
from repro_torch.kernels.segment_agg.ref import neighbor_agg_bwd_ref

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


# runs of 32 rows: one row, a run's edges, the serving path's 128- and
# 4,096-row chunks and their neighbours, and a whole training batch
RUN_NS = [1, 31, 32, 33, 128, 4095, 4096, 4097, 75489]
RUN_ROWS = [(100, torch.float32), (602, torch.float32), (37, torch.bfloat16)]


@pytest.mark.parametrize("F,dtype", RUN_ROWS, ids=lambda v: str(v))
@pytest.mark.parametrize("n", RUN_NS)
def test_cache_gather_kernel_bit_exact_over_runs(card, n, F, dtype):
    # misses and slots past C (clamped to C - 1) in every case
    rng = np.random.default_rng(n)
    C = 98000 if n > 4097 else 1000
    cache = torch.from_numpy(rng.normal(0, 1, (C, F)).astype(np.float32))
    slots = rng.integers(-1, C + 8, n).astype(np.int32)
    slots[rng.random(n) < 0.25] = -1
    slots[0] = C + 3 if n > 1 else slots[0]
    slots, cache = torch.from_numpy(slots).to(card), cache.to(card, dtype)
    out, miss = cache_gather(slots, cache)
    ref_out, ref_miss = cache_gather_ref(slots.cpu(), cache.cpu())
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), ref_out) and torch.equal(miss.cpu(), ref_miss)


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
    # |got - want| <= rel * (|want| + max|want|): dw is a warp reduction,
    # summed in another order than the plain version's, so entries near zero
    # are held to the largest
    bound = rel * (want.abs() + want.abs().max())
    assert bool(((got - want).abs() <= bound).all()), \
        float((got - want).abs().max())


def _cpu_bwd(idx, dout, h, m, wt):
    # the plain backward on CPU copies: index_add_ in ascending entry order,
    # which the kernel's dh must equal bit for bit
    from repro_torch.kernels.segment_agg.ref import neighbor_agg_bwd_ref
    return neighbor_agg_bwd_ref(idx.cpu(), dout.cpu(), h.cpu(), m,
                                None if wt is None else wt.cpu())


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
    dh_c, _ = _cpu_bwd(idx, dout, h, m, wt)
    torch.cuda.synchronize()
    assert (neighbor_agg.launches - fwd, neighbor_agg_backward.launches
            - bwd) == (1, 1)
    # forward: sums in index order, as the plain version; 1e-5 for rounding
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    assert not out[1].any()
    assert torch.equal(dh.cpu(), dh_c)
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
    assert torch.equal(grads[0].cpu(), _cpu_bwd(idx, dout, h, m, wt)[0])
    if wa is not None:
        _close_to(grads[1], dw_r, 1e-5)


@pytest.mark.parametrize("mode", AGG_MODES)
@pytest.mark.parametrize("shape", [(8192, 90112, 10, 256), (40, 90, 37, 100)],
                         ids=lambda s: "x".join(map(str, s)))
def test_neighbor_agg_backward_is_deterministic(card, shape, mode):
    from repro_torch.kernels.segment_agg.ops import neighbor_agg_backward
    idx, h, w, dout = _agg_inputs(*shape, card, seed=5)
    m, wt = _mode(mode, w)
    first = neighbor_agg_backward(idx, dout, h, m, wt)
    second = neighbor_agg_backward(idx, dout, h, m, wt)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    if wt is not None:
        assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("mode", AGG_MODES)
def test_neighbor_agg_backward_subnormal_gradients_bit_equal(card, mode):
    # output gradients near 2^-135 (subnormal): the mean divides them with
    # __fdiv_rn, not with its double product; every eighth row near 2^-95
    from repro_torch.kernels.segment_agg.ops import neighbor_agg_backward
    idx, h, w, dout = _agg_inputs(64, 400, 12, 37, "cpu", seed=6)
    dout = dout * 2.0 ** -135
    dout[::8] *= 2.0 ** 40
    idx[:, 0] = 3                                # a source longer than 32
    m, wt = _mode(mode, w)
    dh_c, _ = neighbor_agg_bwd_ref(idx, dout, h, m, wt)
    dh, _ = neighbor_agg_backward(idx.to(card), dout.to(card), h.to(card), m,
                                  None if wt is None else wt.to(card))
    torch.cuda.synchronize()
    assert bool(((dh_c != 0) & (dh_c.abs() < 2.0 ** -126)).any())
    assert torch.equal(dh.cpu(), dh_c)


def test_neighbor_agg_backward_refuses_a_fanout_past_2_24(card):
    # the mean's division is a double product, exact for counts <= 2^24
    from repro_torch.kernels.segment_agg.ops import neighbor_agg_backward
    idx = torch.zeros((1, 2**24 + 1), dtype=torch.int32, device=card)
    h, dout = torch.ones((2, 3), device=card), torch.ones((1, 3), device=card)
    launches = neighbor_agg_backward.launches
    with pytest.raises(ValueError, match="2\\^24"):
        neighbor_agg_backward(idx, dout, h, "mean")
    assert neighbor_agg_backward.launches == launches


def _skewed(kind, seed=0):
    """(idx (Nd, fan) int32, Ns, D) whose transposed segments are skewed:
    one source in every slot (a segment of 81,920), segments of exactly
    31, 32, 33, 63, 64, 65 and 1,025 entries (the edges of one and of two
    ids a lane, and a long source), indices past Ns (clamped), fan = 0, and
    rows of all padding."""
    rng = np.random.default_rng(seed)
    if kind == "one_source":
        return np.full((8192, 10), 7, np.int32), 50, 40
    if kind == "runs_31_to_65_and_1025":
        idx = rng.integers(20, 3000, (300, 8)).astype(np.int32)
        idx[rng.random(idx.shape) < 0.1] = -1
        flat = idx.reshape(-1)
        pos = rng.permutation(flat.size)
        at = 0
        for src, length in ((10, 31), (11, 32), (12, 33), (13, 1025),
                            (14, 63), (15, 64), (16, 65)):
            flat[pos[at:at + length]] = src
            at += length
        return idx, 3000, 37
    if kind == "clamped":
        return rng.integers(-1, 70, (64, 12)).astype(np.int32), 40, 64
    if kind == "fan0":
        return np.zeros((16, 0), np.int32), 9, 24
    idx = rng.integers(-1, 30, (50, 6)).astype(np.int32)      # padding_rows
    idx[[0, 1, 49]] = -1
    return idx, 30, 602


SKEWED = ["one_source", "runs_31_to_65_and_1025", "clamped", "fan0",
          "padding_rows"]


@pytest.mark.parametrize("mode", AGG_MODES)
@pytest.mark.parametrize("kind", SKEWED)
def test_neighbor_agg_backward_skewed_segments_bit_equal(card, kind, mode):
    from repro_torch.kernels.segment_agg.ops import neighbor_agg_backward
    from repro_torch.kernels.segment_agg.ref import neighbor_agg_bwd_ref
    idx, ns, d = _skewed(kind)
    rng = np.random.default_rng(1)
    h, dout = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
               for s in ((ns, d), (idx.shape[0], d)))
    w = torch.from_numpy(rng.uniform(0, 1, idx.shape).astype(np.float32))
    idx = torch.from_numpy(idx)
    m, wt = _mode(mode, w)
    dh_c, dw_c = neighbor_agg_bwd_ref(idx, dout, h, m, wt)
    args = [x.to(card) for x in (idx, dout, h)]
    wg = None if wt is None else wt.to(card)
    launches = neighbor_agg_backward.launches
    dh, dw = neighbor_agg_backward(*args, m, wg)
    again, _ = neighbor_agg_backward(*args, m, wg)
    torch.cuda.synchronize()
    assert neighbor_agg_backward.launches == launches + 2
    assert torch.equal(dh.cpu(), dh_c) and torch.equal(again, dh)
    if wt is not None:
        assert dw.shape == dw_c.shape
        if dw_c.numel():
            _close_to(dw.cpu(), dw_c, 1e-5)


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


# ---------------------------------------------------------------------------
# the forwards' order of adds: bit-equal to the reference order written out
# ---------------------------------------------------------------------------

def _in_order(rows, idx, mode):
    """From +0, acc = acc + where(valid_f, row_f, 0) over ascending f, then
    / max(cnt, 1) for the mean: the order both forward kernels keep (f32,
    one rounding per operation).  Indices past the rows clamp."""
    valid = idx >= 0
    safe = idx.clamp(0, rows.shape[0] - 1).long()
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    acc = torch.zeros((idx.shape[0], rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for f in range(idx.shape[1]):
        acc = acc + torch.where(valid[:, f, None], rows[safe[:, f]], zero)
    if mode == "mean":
        acc = acc / valid.sum(1, keepdim=True).clamp(min=1).to(rows.dtype)
    return acc


def _padded_idx(rng, nd, ns, fan):
    """(nd, fan) int32 as the sampler pads it (each row's valid entries
    first), with holes, and one index past Ns (clamped to Ns - 1)."""
    idx = rng.integers(0, ns, (nd, fan)).astype(np.int32)
    size = rng.integers(0, fan + 1, (nd, 1))
    idx = np.where(np.arange(fan) < size, idx, -1).astype(np.int32)
    idx[rng.random(idx.shape) < 0.05] = -1
    if fan:
        idx[0, 0] = ns + 3
    return idx


# (nd, ns, fan, D).  The full-width hops 1 and 2, and every variant the
# launcher picks, at each word size (on an H100's 132 SMs, 128-thread
# blocks, 2 rows a pass at D = 47, 102 and 256): fanouts up to 8 take 4
# passes of 2 slots from 4,224 rows (a tile of 8 rows: Nd = 4,999, 5,000,
# 5,001), 2 passes of 4 from 2,112, else 1 pass of 8; fanouts up to 12 take
# 2 passes of 4 or 1 of 8 (a tile of 2 rows: Nd = 1, 2, 3); wider ones 1
# pass of 16.  Fan 0, 1 and 33; D = 602, a row wider than a block (column
# tiles).  D = 47 reads 4-byte words, 102 and 602 8-byte, 100 and 256 16.
NEIGHBOR_FWD = [(8192, 90112, 10, 256), (512, 8192, 15, 256),
                (4999, 6000, 5, 256), (5000, 6000, 5, 256),
                (5001, 6000, 5, 256), (3000, 6000, 5, 256),
                (300, 3000, 5, 256), (1, 50, 10, 256), (2, 50, 10, 256),
                (3, 50, 10, 256), (64, 200, 0, 256), (64, 200, 1, 256),
                (300, 500, 33, 100), (77, 300, 15, 47), (5000, 6000, 5, 47),
                (3000, 6000, 5, 47), (300, 3000, 5, 47),
                (5000, 6000, 5, 102), (3000, 6000, 10, 102),
                (300, 3000, 5, 102), (300, 900, 33, 602), (9, 20, 4, 602)]


@pytest.mark.parametrize("mode", AGG_MODES)
@pytest.mark.parametrize("shape", NEIGHBOR_FWD,
                         ids=lambda s: "x".join(map(str, s)))
def test_neighbor_agg_forward_keeps_the_reference_order(card, shape, mode):
    from repro_torch.kernels.segment_agg.ops import neighbor_agg
    from repro_torch.kernels.segment_agg.ref import neighbor_agg_ref
    nd, ns, fan, d = shape
    rng = np.random.default_rng(nd * 31 + fan)
    idx = torch.from_numpy(_padded_idx(rng, nd, ns, fan)).to(card)
    h = torch.from_numpy(rng.normal(0, 1, (ns, d)).astype(np.float32)).to(card)
    w = torch.from_numpy(rng.uniform(0, 1, (nd, fan)).astype(np.float32)).to(card)
    m, wt = _mode(mode, w)
    launches = neighbor_agg.launches
    out = neighbor_agg(idx, h, m, wt)
    torch.cuda.synchronize()
    assert neighbor_agg.launches == launches + 1
    if wt is None:
        assert torch.equal(out, _in_order(h, idx, m))
    else:
        # one fma a weighted add in the kernel, two roundings in the plain
        # version: 1e-5 for rounding
        torch.testing.assert_close(out, neighbor_agg_ref(idx, h, m, wt),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fan", [5, 10, 15])
def test_neighbor_agg_forward_off_16_byte_alignment(card, fan):
    # h 4 bytes into its buffer: the 4-byte words at D = 256
    from repro_torch.kernels.segment_agg.ops import neighbor_agg
    rng = np.random.default_rng(fan)
    idx = torch.from_numpy(_padded_idx(rng, 600, 900, fan)).to(card)
    h = torch.from_numpy(rng.normal(0, 1, (900, 256)).astype(np.float32))
    buf = torch.empty(h.numel() + 1, device=card)
    shifted = buf[1:].view(h.shape)
    shifted.copy_(h)
    for m in ("mean", "sum"):
        out = neighbor_agg(idx, shifted, m)
        torch.cuda.synchronize()
        assert torch.equal(out, _in_order(h.to(card), idx, m))


def _gather_inputs(ns, nd, fan, c, na, f, miss, seed):
    """enc with a share ``miss`` of sideband rows, slots past C and rows
    past Na (clamped), padded entries (-1, aux[0]); idx as the sampler pads
    it, with indices past Ns; the table and the sideband."""
    rng = np.random.default_rng(seed)
    enc = rng.integers(0, c + 8, ns).astype(np.int32)
    sideband = rng.random(ns) < miss
    enc[sideband] = -rng.integers(1, na + 4, int(sideband.sum()))
    enc[-2:] = -1
    idx = _padded_idx(rng, nd, ns, fan)
    return [torch.from_numpy(a) for a in (
        enc, idx, rng.normal(0, 1, (c, f)).astype(np.float32),
        rng.normal(0, 1, (na, f)).astype(np.float32))]


# (ns, nd, fan, C, Na, F, share from the sideband).  Layer 0 at full width,
# all rows resident and half from the sideband; tile edges (F = 100: a pass
# of 5 rows on 128 threads, Nd = 1, 4, 5, 6; 4 passes, 20 rows, from 10,560
# rows on 132 SMs: Nd = 10,559, 10,560, 10,561); fan 0, 1, 3, 10 and 33;
# 4, 8 and 16 neighbour words a round at F = 100 (16-byte words), 47
# (4-byte) and 102 (8-byte); F = 602, a row wider than a block
GATHER_FWD = [(98000, 90112, 5, 98000, 64, 100, 0.0),
              (98000, 90112, 5, 98000, 49000, 100, 0.5),
              (12, 1, 5, 30, 4, 100, 0.5), (12, 4, 5, 30, 4, 100, 0.5),
              (12, 5, 5, 30, 4, 100, 0.5), (12, 6, 5, 30, 4, 100, 0.5),
              (11000, 10559, 5, 12000, 500, 100, 0.3),
              (11000, 10560, 5, 12000, 500, 100, 0.3),
              (11000, 10561, 5, 12000, 500, 100, 0.3),
              (40, 30, 0, 30, 3, 100, 0.3), (40, 30, 1, 30, 3, 100, 0.3),
              (40, 30, 3, 30, 3, 100, 0.3), (400, 60, 10, 500, 4, 100, 0.3),
              (400, 60, 33, 500, 4, 100, 0.3), (300, 100, 3, 200, 10, 47, 0.3),
              (300, 100, 7, 200, 10, 47, 0.3), (300, 100, 12, 200, 10, 47, 0.3),
              (300, 100, 3, 200, 10, 102, 0.3), (300, 100, 7, 200, 10, 102, 0.3),
              (300, 100, 12, 200, 10, 102, 0.3), (40, 9, 4, 30, 3, 602, 0.3)]


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("shape", GATHER_FWD,
                         ids=lambda s: "x".join(map(str, s)))
def test_gather_aggregate_keeps_the_reference_order(card, shape, mode):
    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.kernels.fused_gather_agg.ref import resolve_rows_ref
    enc, idx, table, aux = (t.to(card) for t in _gather_inputs(
        *shape, seed=shape[1]))
    launches = gather_aggregate.launches
    h, a = gather_aggregate(enc, idx, table, aux, mode=mode)
    rows = resolve_rows_ref(enc, table, aux)
    torch.cuda.synchronize()
    assert gather_aggregate.launches == launches + 1
    assert torch.equal(h, rows[:idx.shape[0]])
    assert torch.equal(a, _in_order(rows, idx, mode))


def test_gather_aggregate_off_16_byte_alignment(card):
    # the table 4 bytes into its buffer: the 4-byte words at F = 100
    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.kernels.fused_gather_agg.ref import resolve_rows_ref
    enc, idx, table, aux = (t.to(card) for t in _gather_inputs(
        3000, 2000, 5, 2500, 40, 100, 0.5, seed=9))
    buf = torch.empty(table.numel() + 1, device=card)
    shifted = buf[1:].view(table.shape)
    shifted.copy_(table)
    rows = resolve_rows_ref(enc, table, aux)
    for mode in ("mean", "sum"):
        h, a = gather_aggregate(enc, idx, shifted, aux, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(h, rows[:idx.shape[0]])
        assert torch.equal(a, _in_order(rows, idx, mode))


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


# ---------------------------------------------------------------------------
# flash_attention and the LM serving slice
# ---------------------------------------------------------------------------

# (B, S, H, Hkv, Dh, causal): the qwen3-4b prefill, odd lengths, a
# non-causal tile, the smoke head width and the JAX kernel test's shapes;
# the edges of the bf16 kernel's 128-row tiles (a partial diagonal, one row
# past a tile, a partial last KV tile), Dh=64 non-causal and one kv head
FLASH_SHAPES = [(2, 4096, 32, 8, 128, True), (1, 37, 4, 2, 128, True),
                (1, 1000, 4, 1, 64, True), (1, 256, 2, 2, 128, False),
                (2, 130, 4, 2, 16, True), (2, 128, 3, 3, 32, False),
                (1, 1, 2, 2, 64, True), (1, 127, 4, 2, 128, True),
                (1, 129, 4, 2, 128, True), (2, 4097, 8, 2, 128, True),
                (1, 300, 4, 2, 64, False), (1, 513, 8, 1, 128, True)]
# f32: the JAX kernel test's tolerance.  bf16 is held to ``bf16_excess``
# (ref.py): per element rtol 1e-2 plus the bound of rounding P to bf16,
# 2^-8 (P |v|), and per row 1e-2 of the row's norm; a fixed atol would
# exceed the outputs of long rows (|out| ~ S^-1/2)
F32_TOL = dict(atol=2e-5, rtol=1e-4)


def _flash_inputs(B, S, H, Hkv, Dh, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device, dtype)
            for shape in ((B, S, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_kernel_matches_plain(card, shape, dtype):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (bf16_excess,
                                                         flash_attention_ref)
    *dims, causal = shape
    q, k, v = _flash_inputs(*dims, dtype, card)
    launches = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    if dtype == torch.bfloat16:
        assert max(bf16_excess(out, q, k, v, causal)) <= 1
    else:
        ref = flash_attention_ref(q, k, v, causal=causal)
        torch.testing.assert_close(out, ref, **F32_TOL)


@pytest.mark.parametrize("shape", [(2, 4096, 32, 8, 128, True),
                                   (1, 1000, 4, 2, 64, False)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_bf16_kernel_is_deterministic(card, shape):
    # no atomics: every output element is one block's sum in a fixed order
    from repro_torch.kernels.flash_attention.ops import flash_attention
    *dims, causal = shape
    q, k, v = _flash_inputs(*dims, torch.bfloat16, card)
    first = flash_attention(q, k, v, causal=causal)
    second = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_flash_attention_rejects_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q, k, v = _flash_inputs(1, 64, 2, 2, 64, torch.float32, card)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    q, k, v = _flash_inputs(1, 64, 2, 2, 48, torch.float32, card)
    with pytest.raises(ValueError, match="Dh"):
        flash_attention(q, k, v)
    q, k, v = _flash_inputs(1, 64, 2, 2, 64, torch.float16, card)
    with pytest.raises(TypeError):
        flash_attention(q, k, v)


def test_cuda_tensors_never_reach_attention_ref(card, monkeypatch):
    import repro_torch.kernels.flash_attention.ops as fa
    from repro_torch.configs import get_config
    from repro_torch.models.api import build, compute_params
    from repro_torch.models.params import init_params

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    monkeypatch.setattr(fa, "flash_attention_ref", refuse)
    cfg = get_config("qwen3-4b", smoke=True)
    model = build(cfg)
    params = init_params(model.decls, torch.Generator().manual_seed(0), card)
    launches = fa.flash_attention.launches
    logits, caches = model.prefill(compute_params(params, cfg), {
        "tokens": torch.randint(0, cfg.vocab_size, (2, 40), device=card)})
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - launches == cfg.num_layers
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["qwen3-4b", "llama3.2-3b"])
def test_lm_prefill_and_engine_on_card_match_cpu(card, arch):
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import Engine, Request
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    model = build(cfg)
    params = {dev: init_params(model.decls, torch.Generator().manual_seed(0),
                               dev) for dev in ("cpu", card)}
    toks = torch.randint(0, cfg.vocab_size, (2, 70),
                         generator=torch.Generator().manual_seed(1))
    got, _ = model.prefill(params[card], {"tokens": toks.to(card)})
    want, _ = model.prefill(params["cpu"], {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    streams = []
    for dev in ("cpu", card):
        eng = Engine(cfg, params=params[dev], batch=2, max_len=32, device=dev)
        rng = np.random.default_rng(0)
        for rid in range(4):
            eng.submit(Request(rid=rid, prompt=rng.integers(
                1, cfg.vocab_size, 6).astype(np.int32), max_new_tokens=4))
        eng.run_to_completion()
        streams.append({r.rid: r.out_tokens for r in eng.completed})
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# reservoir_topm
# ---------------------------------------------------------------------------

# the padded widths the sampler buckets a full-width graphsage-products hop
# into, and fanouts around and past the per-thread list of 32
RESERVOIR_WIDTHS = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                    16384, 32768, 65536, 131072]
RESERVOIR_MS = [2, 5, 10, 15, 25, 40]
TIE_U = np.array([0.0, 0.2, 0.5, 0.7, 0.9], np.float32)


def _reservoir_inputs(R, N, device, kind="sampler", seed=0):
    """w, u (R, N) float32 and mask (R, N) bool.  ``sampler``: each row's
    first size lanes valid, size in (N/2, N], a few holes; ``ties``: u from
    five values and w from two, so keys tie exactly; ``u_zero``: 30% of u
    is 0; ``all_masked_row``: row R // 2 has no valid lane; ``sparse``: 1
    lane in 200 valid, so wide rows run out before m."""
    rng = np.random.default_rng(seed)
    w = np.where(rng.random((R, N)) < 0.3, 4.0, 1.0).astype(np.float32)
    u = rng.random((R, N), dtype=np.float32)
    size = rng.integers(N // 2 + 1, N + 1, (R, 1))
    mask = (np.arange(N) < size) & (rng.random((R, N)) < 0.97)
    if kind == "ties":
        u = TIE_U[rng.integers(0, len(TIE_U), (R, N))]
    elif kind == "u_zero":
        u[rng.random((R, N)) < 0.3] = 0.0
    elif kind == "all_masked_row":
        mask[R // 2] = False
    elif kind == "sparse":
        mask = rng.random((R, N)) < 0.005
    return [torch.from_numpy(x).to(device) for x in (w, u, mask)]


def _assert_reservoir_bit_exact(w, u, mask, m, plan=None):
    from repro_torch.kernels.reservoir.ops import reservoir_topm
    from repro_torch.kernels.reservoir.ref import NEG, reservoir_topm_ref
    launches = reservoir_topm.launches
    idx, keys = reservoir_topm(w, u, mask, m, plan=plan)
    r_idx, r_keys = reservoir_topm_ref(w, u, mask.bool(), m)
    torch.cuda.synchronize()
    assert reservoir_topm.launches == launches + 1
    assert idx.dtype == torch.int32 and keys.dtype == torch.float32
    assert torch.equal(idx, r_idx)
    assert torch.equal(keys.view(torch.int32), r_keys.view(torch.int32))
    assert bool((keys[idx == w.shape[1]] == NEG).all())


@pytest.mark.parametrize("m", RESERVOIR_MS)
@pytest.mark.parametrize("N", RESERVOIR_WIDTHS)
def test_reservoir_kernel_matches_plain_bit_exact(card, N, m):
    R = max(2, min(256, 2**18 // N))
    _assert_reservoir_bit_exact(*_reservoir_inputs(R, N, card), m)


@pytest.mark.parametrize("kind", ["ties", "u_zero", "all_masked_row",
                                  "sparse"])
@pytest.mark.parametrize("R,N,m", [(13, 37, 5), (4, 5, 9), (6, 1, 3),
                                   (40, 256, 10), (3, 4096, 40),
                                   (1, 70217, 10)])
def test_reservoir_kernel_edge_cases_bit_exact(card, R, N, m, kind):
    _assert_reservoir_bit_exact(*_reservoir_inputs(R, N, card, kind), m)


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8, torch.int8,
                                   torch.int64])
@pytest.mark.parametrize("N", [100, 3000])
def test_reservoir_kernel_takes_integer_masks(card, N, dtype):
    w, u, mask = _reservoir_inputs(9, N, card)
    _assert_reservoir_bit_exact(w, u, mask.to(dtype) * 3, 12)


def test_reservoir_routes_and_counts(card, monkeypatch):
    import repro_torch.kernels.reservoir.ops as ops
    from repro_torch.kernels.reservoir.ref import reservoir_topm_ref
    w, u, mask = _reservoir_inputs(8, 300, card)
    launches = ops.reservoir_topm.launches
    got = ops.reservoir_topm(w.cpu(), u.cpu(), mask.cpu(), 7)   # plain
    want = reservoir_topm_ref(w.cpu(), u.cpu(), mask.cpu(), 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.reservoir_topm.launches == launches
    with pytest.raises(ValueError, match="contiguous"):
        ops.reservoir_topm(w.t().contiguous().t(), u, mask, 7)
    with pytest.raises(TypeError):
        ops.reservoir_topm(w, u, mask.float(), 7)
    with pytest.raises(TypeError):
        ops.reservoir_topm(w.to(torch.complex64), u, mask, 7)
    with pytest.raises(ValueError):
        ops.reservoir_topm(w, u.cpu(), mask, 7)
    assert ops.reservoir_topm.launches == launches

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ops, "reservoir_topm_ref", refuse)
    idx, _ = ops.reservoir_topm(w, u, mask, 7)
    torch.cuda.synchronize()
    assert ops.reservoir_topm.launches == launches + 1
    assert idx.shape == (8, 7) and idx.is_cuda


# the chunked kernel at its borders: every chunk size the launcher uses
# (one block a row up to 2,048 lanes, chunks over blocks past it), each as
# the launcher's layout and cut at that size
RESERVOIR_CHUNKS = sorted({layout(N).chunk_lanes for N in RESERVOIR_WIDTHS
                           if N > 32})
SPLIT_CHUNKS = sorted({layout(N).chunk_lanes for N in RESERVOIR_WIDTHS
                       if layout(N).P > 1})


def _cut_at(N, C):
    """Layouts that cut rows of N lanes at chunks of C lanes: one chunk a
    block (W = 8 past 256 lanes, else one warp), and one block walking the
    row in sub-chunks of C."""
    W = 8 if C >= 256 else 1
    K = C // (32 * W)
    return [chunked(N, K, W, N), chunked(N, K, W, 1)]


def _reservoir_plans(N, C):
    """The launcher's layout, the row cut at C, and chunks of 64 lanes
    (past 32 of them, the last block merges in two levels)."""
    return list(dict.fromkeys([layout(N), *_cut_at(N, C),
                               chunked(N, 1, 2, N)]))


def _reservoir_rows(R, N, C, kind, device, seed=0):
    """``border_ties``: w = 1 and the four lanes around every multiple of C
    and of 32 share each row's top key; ``one_chunk``: every valid lane in
    one chunk; ``exhausted``: the first chunk masked whole, the second with
    3 valid lanes, the rest 80% valid."""
    rng = np.random.default_rng(seed)
    w, u, mask = (x.cpu().numpy() for x in _reservoir_inputs(R, N, "cpu",
                                                              seed=seed))
    if kind == "border_ties":
        w[:] = 1.0
        u = (rng.random((R, N)) * 0.5).astype(np.float32)
        for step in (C, 32):
            for b in range(step, N, step):
                u[:, max(b - 2, 0):b + 2] = 0.9
    elif kind == "one_chunk":
        at = (rng.integers(0, max(N // C, 1), R) * C)[:, None]
        mask = ((np.arange(N) >= at) & (np.arange(N) < at + C)
                & (rng.random((R, N)) < 0.8))
    elif kind == "exhausted":
        mask = rng.random((R, N)) < 0.8
        mask[:, :2 * C] = False
        three = C + np.array([1, C // 2, C - 1])
        mask[:, three[three < N]] = True
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (w, u, mask)]


@pytest.mark.parametrize("m", [5, 10])
@pytest.mark.parametrize("delta", ["-1", "0", "+1", "C+1"])
@pytest.mark.parametrize("C", RESERVOIR_CHUNKS)
def test_reservoir_chunk_borders_bit_exact(card, C, delta, m):
    N = C + {"-1": -1, "0": 0, "+1": 1, "C+1": C + 1}[delta]
    w, u, mask = _reservoir_inputs(7, N, card, seed=N)
    for plan in _reservoir_plans(N, C):
        _assert_reservoir_bit_exact(w, u, mask, m, plan)


@pytest.mark.parametrize("kind", ["border_ties", "one_chunk", "exhausted"])
@pytest.mark.parametrize("mult", [2, 8])
@pytest.mark.parametrize("C", SPLIT_CHUNKS)
def test_reservoir_split_rows_bit_exact(card, C, mult, kind):
    """Ties that straddle a chunk border, a row whose valid lanes all sit in
    one chunk, and all-masked chunks beside chunks with fewer valid lanes
    than m, at 2C + 1 and 8C + 3 lanes."""
    N = mult * C + (1 if mult == 2 else 3)
    w, u, mask = _reservoir_rows(5, N, C, kind, card, seed=C + mult)
    for plan in _reservoir_plans(N, C):
        _assert_reservoir_bit_exact(w, u, mask, 10, plan)


@pytest.mark.parametrize("R,N", [(4, 16384), (3, 70217), (2, 131072)])
def test_reservoir_m40_on_split_rows(card, R, N):
    """m = 40, past the 32 keys of a warp's chunk: one merge level (32
    chunks at 16,384 lanes), two past it."""
    w, u, mask = _reservoir_inputs(R, N, card, seed=R)
    for plan in _reservoir_plans(N, 1024):
        _assert_reservoir_bit_exact(w, u, mask, 40, plan)


@pytest.mark.parametrize("R,N,m", [(300, 8192, 5), (64, 70217, 10),
                                   (2000, 4096, 15)])
def test_reservoir_many_waves_of_chunks(card, R, N, m):
    """Buckets whose rows × chunks far exceed one wave of the card's SMs
    (8,832 to 32,000 blocks), each row's last block merging its lists."""
    assert R * layout(N).P > 50 * torch.cuda.get_device_properties(
        card).multi_processor_count
    _assert_reservoir_bit_exact(*_reservoir_inputs(R, N, card), m)


def test_reservoir_launches_repeat_bit_equal(card):
    """The row counters are left at 0 by every launch: launches on one
    stream, split and not, wide and narrow, interleaved, repeat bit for
    bit."""
    from repro_torch.kernels.reservoir.ops import reservoir_topm
    cases = [(_reservoir_inputs(R, N, card, seed=N), m)
             for R, N, m in [(3, 70217, 5), (40, 4096, 10), (7, 8, 5),
                             (16, 8192, 5)]]
    first = [reservoir_topm(*x, m) for x, m in cases]
    for _ in range(3):
        for (x, m), (idx, keys) in zip(cases, first):
            again = reservoir_topm(*x, m)
            assert torch.equal(again[0], idx) and torch.equal(
                again[1].view(torch.int32), keys.view(torch.int32))
    for x, m in cases:
        _assert_reservoir_bit_exact(*x, m)


@pytest.mark.parametrize("N,m,cut", [(40000, 1500, False), (5000, 3000, True)])
def test_reservoir_lists_past_shared_memory(card, N, m, cut):
    """m so large that a block's lists outgrow shared memory and live in
    its scratch: the final merge's lists at 40,000 lanes, the running list
    of one block walking 5,000 lanes in sub-chunks."""
    w, u, mask = _reservoir_inputs(2, N, card, seed=m)
    plan = chunked(N, 1, 8, 1) if cut else None
    _assert_reservoir_bit_exact(w, u, mask, m, plan)


def test_reservoir_refuses_a_layout_that_does_not_fit(card):
    from repro_torch.kernels.reservoir.ops import Layout, reservoir_topm
    w, u, mask = _reservoir_inputs(3, 300, card)
    launches = reservoir_topm.launches
    for plan in (Layout(0, 3, 8, 1, 1), Layout(0, 1, 1, 1, 1),
                 Layout(seg=16), Layout(0, 1, 1, 40, 1)):
        with pytest.raises(ValueError, match="layout"):
            reservoir_topm(w, u, mask, 5, plan=plan)
    assert reservoir_topm.launches == launches


# ---------------------------------------------------------------------------
# the multi-partition slice: the fused global step and the checkpoint
# ---------------------------------------------------------------------------

def test_two_partition_fused_global_step_on_the_card(card):
    """Two fused 2-partition global steps on the card against the same
    steps on the CPU: the same seeded parameters, the same plan and the
    same sampled batches; each partition's loss within rel 1e-4."""
    from repro_torch.core.multipart import MultiPartitionTrainer
    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.models.params import leaves
    cfg = gnn_config("products", smoke=True, partitions=2, halo_budget=32,
                     fused_gather_agg=True, sampling_device="device",
                     cache_volume_mb=0.1)
    runs = []
    for dev in (card, "cpu"):
        tr = MultiPartitionTrainer(dataset_like(cfg, seed=0), cfg, seed=0,
                                   device=dev)
        launches = gather_aggregate.launches
        try:
            tr.global_step()
            tr.global_step()
        finally:
            for s in tr.slots:
                s.pipe.shutdown()
        runs.append((tr, gather_aggregate.launches - launches))
    (gpu, n_gpu), (cpu, _) = runs
    assert n_gpu == 4                        # 2 partitions × 2 global steps
    assert all(p.is_cuda for p in leaves(gpu.params))
    assert all(s.pipe.plane.device.type == "cuda" for s in gpu.slots)
    for sg, sc in zip(gpu.slots, cpu.slots):
        np.testing.assert_allclose(sg.pipe.stats.losses, sc.pipe.stats.losses,
                                   rtol=1e-4, atol=0)
        assert sg.cache.stats == sc.cache.stats
        assert sg.halo_stats == sc.halo_stats


def test_checkpoint_from_the_card_restores_onto_it(card, tmp_path):
    from repro_torch.train.checkpoint import CheckpointManager
    g = torch.Generator(device=card).manual_seed(0)
    state = {"params": {"layers": [
        {"w": torch.randn(100, 256, device=card, generator=g),
         "b": torch.randn(256, device=card, generator=g)}]},
        "opt_state": {"count": 3}}
    want = state["params"]["layers"][0]["w"].clone()
    cm = CheckpointManager(tmp_path, async_save=True)
    cm.save(3, state)
    state["params"]["layers"][0]["w"].add_(1.0)   # after the snapshot
    cm.wait()
    out, step = cm.restore(state)
    assert step == 3 and out["opt_state"]["count"] == 3
    got = out["params"]["layers"][0]
    assert got["w"].is_cuda and torch.equal(got["w"], want)
    assert torch.equal(got["b"], state["params"]["layers"][0]["b"])


# ---------------------------------------------------------------------------
# the online auto-tuner: PPO on the card, and scripted episodes
# ---------------------------------------------------------------------------

def test_ppo_update_on_the_card_matches_the_cpu(card):
    """One seed gives the same initial nets on either device; one rollout
    on the CPU and one update on each: every parameter within 1e-5."""
    from repro_torch.core.autotune.ppo import PPOAgent, PPOConfig
    from repro_torch.core.autotune.space import Space

    def evaluate(cfg):
        u = Space().encode(cfg)
        return {"throughput": 1.0 + u[0] * u[4], "memory": 1e8 * (1 + u[5]),
                "accuracy": 0.7 + 0.1 * u[2]}
    agents = [PPOAgent(Space(), evaluate, {"throughput": 1.0},
                       lambda m: True, PPOConfig(seed=1), device=dev)
              for dev in ("cpu", card)]
    host, gpu = agents
    for x, y in zip(gpu.parameters(), host.parameters(), strict=True):
        assert x.is_cuda and torch.equal(x.cpu(), y)
    s, a, logp, r, v = host._rollout(np.random.default_rng(0).random(7))
    adv, ret = host._gae(r, v)
    for ag in agents:
        ag._update((s, a, logp, ret, adv))
    for x, y in zip(gpu.parameters(), host.parameters(), strict=True):
        assert x.is_cuda
        np.testing.assert_allclose(x.detach().cpu().numpy(),
                                   y.detach().numpy(), rtol=0, atol=1e-5)


def test_scripted_autotune_on_the_card_matches_the_cpu(card, monkeypatch,
                                                       tmp_path):
    """The controller's episodes with ``propose`` scripted (the plane to
    cpu and back, a restart to 2 partitions with a halo and back) on the
    card and on the CPU: the same configurations, memory, hit rates and
    steps, losses within rel 1e-4, the state carried over each restart
    exactly, and the card's kernels launched on every fused step."""
    from repro_torch.configs.gnn import AutotuneConfig
    from repro_torch.core.a3gnn import A3GNNTrainer
    from repro_torch.core.autotune.controller import AutotuneController
    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.models.params import leaves
    script = [dict(sampling_device="cpu", partitions=1, halo_budget=0),
              dict(sampling_device="device", partitions=2, halo_budget=16),
              dict(sampling_device="device", partitions=1, halo_budget=0)]
    cfg = gnn_config("products", smoke=True, fused_gather_agg=True,
                     sampling_device="device", cache_volume_mb=0.3)
    runs = []
    for i, dev in enumerate((card, "cpu")):
        it, losses, carried = iter(script), [], []
        measure, restart = AutotuneController.measure, \
            AutotuneController._restart

        def measured(self, index, c, predicted=None):
            ep = measure(self, index, c, predicted)
            losses.append(list(self.pipe.stats.losses))
            return ep

        def restarted(self, n, halo_budget=None):
            before = [x.detach().cpu().clone() if torch.is_tensor(x) else x
                      for x in leaves(self.tr.state_dict())]
            restart(self, n, halo_budget)
            carried.append(all(
                torch.equal(x.cpu(), y) if torch.is_tensor(x) else x == y
                for x, y in zip(leaves(self.tr.state_dict()), before)))

        monkeypatch.setattr(AutotuneController, "propose", lambda self: (
            {**self._current_config(), **next(it)}, None))
        monkeypatch.setattr(AutotuneController, "measure", measured)
        monkeypatch.setattr(AutotuneController, "_restart", restarted)
        tr = A3GNNTrainer(dataset_like(cfg, seed=0), cfg, seed=0, device=dev)
        ctrl = AutotuneController(tr, tr.make_pipeline(), AutotuneConfig(
            episodes=len(script) + 1, steps_per_episode=2, warmup_steps=0,
            presample=8, surrogate_trees=4, tune_sampling_device=True,
            max_partitions=2, max_halo_budget=16, w_throughput=0.0,
            w_memory=1.0, w_accuracy=0.0, restart_dir=str(tmp_path / f"run{i}"),
            seed=0))
        launches = gather_aggregate.launches
        try:
            rep = ctrl.run()
        finally:
            ctrl.pipe.shutdown()
        monkeypatch.undo()
        runs.append((rep, losses, carried, ctrl,
                     gather_aggregate.launches - launches))
    (rg, lg, cg, ctrl, n_gpu), (rc, lc, cc, _, _) = runs
    assert cg == cc == [True, True]
    assert n_gpu == sum(ep.steps for ep in rg.episodes) == 2 + 2 + 4 + 2
    assert all(p.is_cuda for p in leaves(ctrl.tr.params))
    for eg, ec, a, b in zip(rg.episodes, rc.episodes, lg, lc, strict=True):
        assert eg.config == ec.config and eg.steps == ec.steps
        assert eg.metrics["memory"] == ec.metrics["memory"]
        assert eg.cache_hit_rate == ec.cache_hit_rate
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# the serving fabric: chaos on the card against the same fabric on the CPU
# ---------------------------------------------------------------------------

def test_fabric_chaos_on_the_card_matches_the_cpu(card):
    """A 2 × 2 smoke fabric of SimHost replicas on a virtual clock, replica
    (0, 0) killed after its 3rd response, on the card and on the CPU from
    the same parameters: the same (rid, partition, replica, status) trace
    and predictions, logits within atol 1e-4, the audit balanced, and one
    ``cache_gather`` launch per gather chunk of the card's planes."""
    from repro_torch.core.a3gnn import A3GNNTrainer
    from repro_torch.graph.partition import plan_partitions
    from repro_torch.models.params import tree_map
    from repro_torch.serve.fabric import ServingFabric
    from repro_torch.serve.gnn_engine import GNNRequest
    from repro_torch.serve.transport import (FaultSpec, VirtualClock,
                                             sim_host_factory)
    cfg = gnn_config("products", smoke=True, sampling_device="device")
    g = dataset_like(cfg, seed=0)
    params = A3GNNTrainer(g, cfg, seed=0, device=card).params
    plan = plan_partitions(g, 2, "locality", seed=0, halo_budget=32)
    nodes = np.random.default_rng(1).choice(g.num_nodes, 48, replace=False)
    runs = []
    for dev, p in ((card, params), ("cpu", tree_map(lambda t: t.cpu(),
                                                    params))):
        fab = ServingFabric.from_plan(
            g, plan, cfg, p, batch=4, replicas=2, seed=0,
            transport_factory=sim_host_factory(
                faults={(0, 0): FaultSpec(added_latency_ms=2,
                                          down_after_responses=3)},
                base=FaultSpec(added_latency_ms=2), seed=0),
            clock=VirtualClock(tick_s=1e-3), timeout_ms=8,
            record_trace=True, device=dev)
        launches = cache_gather.launches
        for i in range(0, len(nodes), 4):
            for rid in range(i, i + 4):
                fab.submit(GNNRequest(rid=rid, node=int(nodes[rid])))
            fab.step()
        fab.drain()
        runs.append((fab, cache_gather.launches - launches))
    (gpu, n_gpu), (cpu, _) = runs
    assert all(e.device.type == "cuda" for e in gpu.all_engines)
    assert n_gpu == sum(p[0].plane.gather_dispatches for p in gpu.engines)
    assert n_gpu > 0
    a = gpu.audit()
    assert a == cpu.audit() and a["pending"] == a["inflight"] == 0
    assert a["offered"] == a["done"] + a["shed"] + a["timed_out"] == 48
    assert gpu.replica_state[(0, 0)].state == "down"
    assert gpu.fstats.timeouts > 0 and gpu.fstats.retries > 0
    assert [e[:4] for e in gpu.request_trace] == \
        [e[:4] for e in cpu.request_trace]
    done = {r.rid: r for r in cpu.completed}
    for r in gpu.completed:
        assert r.pred == done[r.rid].pred
        np.testing.assert_allclose(r.logits, done[r.rid].logits, atol=1e-4,
                                   rtol=0)
