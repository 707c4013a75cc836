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
# past a tile, a partial last KV tile), Dh=64 non-causal and one kv head;
# the widths run on a wider template: Dh=112 (the zamba2-7b prefill, GQA
# as kimi-k2's, ragged and non-causal) and Dh=8 (glm4-9b's smoke config);
# the whisper-medium encoder (non-causal over 1500 frames: a ragged last KV
# tile no causal mask hides) and decoder prefills, and the qwen2-vl-2b
# prefill (a GQA group of 6)
FLASH_SHAPES = [(2, 4096, 32, 8, 128, True), (1, 37, 4, 2, 128, True),
                (1, 1000, 4, 1, 64, True), (1, 256, 2, 2, 128, False),
                (2, 130, 4, 2, 16, True), (2, 128, 3, 3, 32, False),
                (1, 1, 2, 2, 64, True), (1, 127, 4, 2, 128, True),
                (1, 129, 4, 2, 128, True), (2, 4097, 8, 2, 128, True),
                (1, 300, 4, 2, 64, False), (1, 513, 8, 1, 128, True),
                (2, 4096, 32, 32, 112, True), (1, 257, 8, 2, 112, True),
                (1, 300, 4, 2, 112, False), (1, 1, 2, 2, 112, True),
                (2, 130, 8, 2, 8, True), (1, 200, 4, 4, 8, False),
                (1, 1, 2, 1, 8, True), (2, 1500, 16, 16, 64, False),
                (2, 448, 16, 16, 64, True), (2, 4096, 12, 2, 128, True)]
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
                                   (1, 1000, 4, 2, 64, False),
                                   (2, 1500, 16, 16, 64, False),
                                   (2, 1000, 8, 2, 112, True),
                                   (1, 300, 4, 4, 8, False)],
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


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                                  "mamba2-1.3b", "zamba2-7b", "glm4-9b"])
def test_lm_families_on_card_match_cpu(card, arch):
    # the MoE, SSM and hybrid families (and glm4's Dh 8) at f32: the block
    # prefill through the kernel on the card against the CPU's plain
    # version, the engine's greedy streams equal, a slot reused
    import repro_torch.kernels.flash_attention.ops as fa
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import Engine, Request
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    model = build(cfg)
    params = {dev: init_params(model.decls, torch.Generator().manual_seed(0),
                               dev) for dev in ("cpu", card)}
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    launches = fa.flash_attention.launches
    got, _ = model.prefill(params[card], {"tokens": toks.to(card)})
    torch.cuda.synchronize()
    attn = {"ssm": 0, "hybrid": cfg.num_layers // cfg.shared_attn_every}
    assert fa.flash_attention.launches - launches == attn.get(
        cfg.family, cfg.num_layers)
    want, _ = model.prefill(params["cpu"], {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    streams = []
    for dev in ("cpu", card):
        eng = Engine(cfg, params=params[dev], batch=2, max_len=32, device=dev)
        rng = np.random.default_rng(0)
        for rid in range(5):
            eng.submit(Request(rid=rid, prompt=rng.integers(
                1, cfg.vocab_size, 6).astype(np.int32), max_new_tokens=4))
        eng.run_to_completion()
        streams.append({r.rid: r.out_tokens for r in eng.completed})
    assert streams[0] == streams[1]


def _fan_in_params(model, device):
    """``init_params`` (seed 0, drawn on the CPU) with the attention
    weights rescaled to N(0, 1 / their whole fan-in): the initializer reads
    the fan-in of ``wq``/``wk``/``wv`` (D, heads, Dh) from the heads and of
    ``wo`` (H, Dh, D) from Dh, which makes a seeded encoder-decoder stack
    amplify rounding far past the f32 tolerance between two devices."""
    from repro_torch.models.params import init_params
    params = init_params(model.decls, torch.Generator().manual_seed(0), "cpu")

    def fix(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fix(v)
            elif k in ("wq", "wk", "wv"):
                v.mul_((v.shape[-2] / v.shape[-3]) ** 0.5)
            elif k == "wo":
                v.mul_(v.shape[-3] ** -0.5)
    fix(params)
    return {k: _to(v, device) for k, v in params.items()}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _encdec_vlm_batch(cfg, device, B=2, S=40):
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                            generator=g)
    else:       # 16 patches, a 4 x 4 grid, then the text from position 4
        i = torch.arange(S)
        text = 4 + i - 16
        batch["vision_embeds"] = torch.randn((B, 16, cfg.d_model),
                                             generator=g)
        batch["positions"] = torch.stack([
            torch.where(i < 16, 0, text), torch.where(i < 16, i // 4, text),
            torch.where(i < 16, i % 4, text)])[:, None].expand(3, B, S)
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-2b"])
def test_encdec_and_vlm_on_card_match_cpu(card, arch):
    # f32: the block prefill through the kernel on the card (whisper: the
    # encoder's non-causal calls and the decoder's causal ones) against
    # the CPU's plain version, every cache leaf too; the engine's greedy
    # streams equal, a slot reused
    import repro_torch.kernels.flash_attention.ops as fa
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    from repro_torch.serve.engine import Engine, Request
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    model = build(cfg)
    params = {dev: _fan_in_params(model, dev) for dev in ("cpu", card)}
    launches = fa.flash_attention.launches
    got, got_c = model.prefill(params[card], _encdec_vlm_batch(cfg, card))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - launches == (
        cfg.encoder_layers + cfg.num_layers)
    want, want_c = model.prefill(params["cpu"], _encdec_vlm_batch(cfg, "cpu"))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for name in want_c:
        torch.testing.assert_close(got_c[name].cpu(), want_c[name],
                                   atol=1e-4, rtol=1e-4)
    streams = []
    for dev in ("cpu", card):
        eng = Engine(cfg, params=params[dev], batch=2, max_len=32, device=dev)
        rng = np.random.default_rng(0)
        for rid in range(5):
            eng.submit(Request(rid=rid, prompt=rng.integers(
                1, cfg.vocab_size, 6).astype(np.int32), max_new_tokens=4))
        eng.run_to_completion()
        streams.append({r.rid: r.out_tokens for r in eng.completed})
    assert streams[0] == streams[1]


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-2b"])
def test_encdec_and_vlm_bf16_prefill_on_card(card, arch):
    # bf16: every flash_attention call of the prefill within the bf16 bound
    # of the plain version on its own inputs, and two prefills bit-equal
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import bf16_excess
    from repro_torch.models import layers
    from repro_torch.models.api import build, compute_params
    cfg = get_config(arch, smoke=True)
    model = build(cfg)
    params = compute_params(_fan_in_params(model, card), cfg)
    batch = _encdec_vlm_batch(cfg, card, S=min(300, cfg.max_seq))
    kernel, excess = layers.flash_attention, []

    def in_situ(q, k, v, causal=True):
        out = kernel(q, k, v, causal)
        excess.append(max(bf16_excess(out, q, k, v, causal)))
        return out
    layers.flash_attention = in_situ
    try:
        first, c1 = model.prefill(params, batch)
    finally:
        layers.flash_attention = kernel
    second, c2 = model.prefill(params, batch)
    torch.cuda.synchronize()
    assert len(excess) == cfg.encoder_layers + cfg.num_layers
    assert max(excess) <= 1
    assert torch.equal(first, second)
    assert all(torch.equal(c1[n], c2[n]) for n in c1)


def test_moe_prefill_on_card_is_deterministic(card):
    # the experts' outputs are summed back per token in a fixed order (a
    # gather, no atomics): two bf16 prefills are bit-equal, drops included
    from repro_torch.configs import get_config
    from repro_torch.models.api import build, compute_params
    from repro_torch.models.params import init_params
    cfg = get_config("qwen2-moe-a2.7b", smoke=True).replace(
        capacity_factor=0.5)
    model = build(cfg)
    params = compute_params(init_params(
        model.decls, torch.Generator().manual_seed(0), card), cfg)
    toks = torch.randint(0, cfg.vocab_size, (4, 512), device=card,
                         generator=torch.Generator(card).manual_seed(2))
    first, c1 = model.prefill(params, {"tokens": toks})
    second, c2 = model.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert all(torch.equal(c1[n], c2[n]) for n in ("k", "v"))


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_tie_order_on_card_matches_cpu(card, cf):
    # rows drawn from 4 distinct vectors tie exactly: each expert keeps the
    # lower token index among them on the card as on the CPU (JAX's top_k)
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models.api import build
    from repro_torch.models.params import init_params, tree_map
    cfg = get_config("qwen2-moe-a2.7b", smoke=True).replace(
        compute_dtype="float32", capacity_factor=cf)
    params = init_params(build(cfg).decls, torch.Generator().manual_seed(0),
                         "cpu")
    lp = tree_map(lambda a: a[0], params["layers"]["moe"])
    rng = np.random.default_rng(3)
    rows = rng.normal(0, 1, (4, cfg.d_model)).astype(np.float32)
    x = torch.from_numpy(rows[rng.integers(0, 4, 128)].reshape(2, 64, -1))
    scores = torch.from_numpy(
        rng.integers(0, 5, (8, 3, 64)).astype(np.float32))
    with torch.no_grad():
        want, _ = M.moe_mlp(lp, x, cfg)
        got, _ = M.moe_mlp(tree_map(lambda a: a.to(card), lp), x.to(card),
                           cfg)
        wv, wi = M.top_k(scores, 40)
        gv, gi = M.top_k(scores.to(card), 40)
    assert torch.equal(gi.cpu(), wi) and torch.equal(gv.cpu(), wv)
    assert float((got.cpu() - want).abs().max()) <= 1e-5


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


# ---------------------------------------------------------------------------
# flash_attention's backward kernel and LM training
# ---------------------------------------------------------------------------

# every head width the card takes (8 and 112 on the 16- and 128-wide
# templates), causal and full, GQA groups of 1 to 4, ragged lengths, a
# single row, and the llama3.2-3b train step's own shape
FLASH_BWD_SHAPES = [(2, 37, 4, 2, 8, True), (1, 200, 4, 4, 8, False),
                    (2, 130, 4, 1, 16, True), (1, 64, 2, 2, 16, False),
                    (2, 65, 6, 2, 32, True), (1, 300, 4, 4, 32, False),
                    (2, 129, 8, 2, 64, True), (2, 1500, 4, 4, 64, False),
                    (1, 257, 8, 2, 112, True), (1, 300, 4, 2, 112, False),
                    (1, 1, 2, 1, 128, True), (2, 1000, 8, 2, 128, True),
                    (1, 256, 4, 4, 128, False), (8, 128, 24, 8, 128, True)]


def _bwd_case(shape, dtype, device, seed=0):
    from repro_torch.kernels.flash_attention.ops import _forward
    B, S, H, Hkv, Dh, causal = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=g).to(device, dtype)
                   for s in ((B, S, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh),
                             (B, S, H, Dh)))
    o, lse = _forward(q, k, v, causal, with_lse=True)
    return q, k, v, o, lse, do, causal


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_backward_kernel_matches_plain(card, shape, dtype):
    """f32: within 1e-5 of the largest gradient entry of the plain version
    on the same inputs; bf16: each gradient's error against an f64
    reference no worse than twice the plain version's own, rounded to bf16
    (the kernel sums in f32, rounds P and dS to bf16 for the tensor cores
    and each output once)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    args = _bwd_case(shape, dtype, card)
    launches = flash_attention_bwd.launches
    got = flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == launches + 1
    _assert_bwd_close(args, got)


def _assert_bwd_close(args, got):
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    q, k, v, o, lse, do, causal = args
    dtype = q.dtype
    plain = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)), lse,
                                    do.float(), causal)
    exact = flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o)),
                                    lse.double(), do.double(), causal)
    top = max(float(w.abs().max()) for w in plain)
    for g, p, e in zip(got, plain, exact):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        if dtype == torch.float32:
            assert float((g - p).abs().max()) <= 1e-5 * top
        else:
            own = float((p.to(dtype).double() - e).abs().max())
            assert float((g.double() - e).abs().max()) <= 2 * own + 1e-6 * top


# the bf16 kernels' tile edges (64-row tiles, 128-row items): a single row,
# one row short of, at and past a tile and an item, on the 16-wide (Dh 8)
# and 128-wide (Dh 112, 128) templates, causal and full, a GQA group of 2
FLASH_BWD_EDGES = [(1, S, 4, 2, dh, causal) for S in (1, 63, 64, 65, 127, 129)
                   for dh in (8, 112, 128) for causal in (True, False)]


@pytest.mark.parametrize("shape", FLASH_BWD_EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_bf16_backward_tile_edges(card, shape):
    """Each bf16 edge case held as the cases above, and a second run
    bit-equal to the first."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    args = _bwd_case(shape, torch.bfloat16, card)
    got, again = flash_attention_bwd(*args), flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_bwd_close(args, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_deterministic(card, dtype):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    args = _bwd_case((8, 128, 24, 8, 128, True), dtype, card)
    first, second = flash_attention_bwd(*args), flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4096, 24, 8, 128, True),
                                   (1, 257, 8, 2, 112, False),
                                   (2, 130, 8, 2, 8, True)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_forward_output_is_the_same_with_the_lse(card, shape, dtype):
    from repro_torch.kernels.flash_attention.ops import _forward
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    *dims, causal = shape
    q, k, v = _flash_inputs(*dims, dtype, card)
    plain = _forward(q, k, v, causal, with_lse=False)
    out, lse = _forward(q, k, v, causal, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(plain, out)
    _, want = flash_attention_ref(q.float(), k.float(), v.float(), causal,
                                  with_lse=True)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)


def test_flash_attention_function_on_card_matches_cpu(card):
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    q, k, v = _flash_inputs(2, 130, 8, 2, 64, torch.float32, "cpu")
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2))
    grads = {}
    for dev in ("cpu", card):
        ins = [t.to(dev).requires_grad_() for t in (q, k, v)]
        before = (flash_attention.launches, flash_attention_bwd.launches)
        out = flash_attention(*ins, causal=True)
        grads[dev] = torch.autograd.grad(out, ins, do.to(dev))
        after = (flash_attention.launches, flash_attention_bwd.launches)
        assert (after[0] - before[0], after[1] - before[1]) == \
            ((1, 1) if dev == card else (0, 0))
    for g, w in zip(grads[card], grads["cpu"]):
        torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=1e-5)


TRAIN_ARCHS = ["qwen3-4b", "llama3.2-3b", "qwen2-moe-a2.7b", "mamba2-1.3b",
               "zamba2-7b", "whisper-medium"]


def _lm_batch(cfg, device, B=2, S=32):
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                            generator=g)
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_lm_train_step_on_card_matches_cpu(card, arch):
    """One f32 smoke train step (remat "dots") on the card, through the
    flash kernels forward and backward, against the same step on the CPU:
    loss and gradient norm within rel 1e-4; every parameter's gradient
    within 1e-4 of its largest entry (one backward on each device)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.models.api import build
    from repro_torch.models.params import leaves, unflatten
    from repro_torch.train.trainer import make_train_step
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32",
                                               remat="dots")
    model = build(cfg)
    params = {dev: _fan_in_params(model, dev) for dev in ("cpu", card)}
    grads, metrics = {}, {}
    for dev in ("cpu", card):
        p_l = [p.clone().requires_grad_() for p in leaves(params[dev])]
        before = flash_attention_bwd.launches
        loss, _ = model.loss_fn(unflatten(params[dev], p_l),
                                _lm_batch(cfg, dev))
        grads[dev] = torch.autograd.grad(loss, p_l, allow_unused=True)
        if dev == card and cfg.family != "ssm":
            assert flash_attention_bwd.launches > before
        step, opt = make_train_step(model, cfg)
        state = opt.init(params[dev])
        _, _, metrics[dev] = step(params[dev], state, _lm_batch(cfg, dev))
    for key in ("loss", "grad_norm"):
        want = float(metrics["cpu"][key])
        assert abs(float(metrics[card][key]) - want) <= 1e-4 * abs(want)
    for g, w in zip(grads[card], grads["cpu"]):
        assert g is not None and bool(torch.isfinite(g).all())
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max()) + 1e-12


# the partition mesh as a torch.distributed group on the card
GROUP_CFG = dict(smoke=True, partitions=2, halo_budget=32,
                 fused_gather_agg=True, sampling_device="device",
                 cache_policy="static", cache_volume_mb=0.1)


def _group_args(ckpt_dir):
    from repro_torch.launch.train import build_parser
    return build_parser().parse_args(
        ["--arch", "graphsage-products", "--smoke", "--steps", "4",
         "--ckpt-dir", str(ckpt_dir)])


def _bit_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_group_gloo_ranks_sharing_the_card_match_host_sim(card, tmp_path):
    """2 gloo ranks on cuda:0 run the launcher's rank code (fused, smoke
    size): bit-equal to the host-simulated run on the card, and the
    kernels' launches summed over the ranks equal to its."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.build import build
    from repro_torch.launch.group import spawn_partitions
    from repro_torch.launch.train import (gnn_rank, halo_rows, load_graph,
                                          multipartition_summary,
                                          run_gnn_multipartition)
    build(["gather", "segment_agg", "fused_gather_agg"])
    cfg = gnn_config("products", **GROUP_CFG)
    ranks = spawn_partitions(gnn_rank, 2, "gloo", ["cuda:0", "cuda:0"],
                             init_method=f"file://{tmp_path}/store",
                             args=(_group_args(tmp_path / "group"), cfg),
                             timeout=120)
    args = _group_args(tmp_path / "host")
    before = launch_counts()
    rep = run_gnn_multipartition(args, cfg, load_graph(args, cfg))
    torch.cuda.synchronize()
    launches = {k: n - before[k] for k, n in launch_counts().items()}
    try:
        want = multipartition_summary(rep)
        want["halo_rows"] = halo_rows(rep["trainer"])
    finally:
        for t in (rep["trainer"], rep["restored"]):
            for s in t.slots:
                s.pipe.shutdown()
    assert launches["gather_aggregate"] == 8
    assert {k: ranks[0]["launches"][k] + ranks[1]["launches"][k]
            for k in launches} == launches
    for r, got in enumerate(ranks):
        assert _bit_equal(got["losses"][r], want["losses"][r])
        assert _bit_equal(got["halo_rows"][r], want["halo_rows"][r])
        for k, v in want["state"].items():
            assert _bit_equal(got["state"][k], v), k
        for key in ("acc", "restored_acc", "cache_hit_rate", "halo_hit_rate",
                    "report", "fused_grad_calls"):
            assert got[key] == want[key], key
        assert not {"jax", "repro"} & set(got["modules"])


@pytest.mark.parametrize("backend,n", [("gloo", 2), ("nccl", 1)])
def test_group_collectives_on_the_card_match_host_sim(card, tmp_path,
                                                      backend, n):
    """Every group collective with its tensors on cuda:0, over 2 gloo
    ranks and over a one-rank nccl group (device, layout and dtypes on
    NCCL), bit-equal to the host-simulated forms on the card."""
    from repro_torch.distributed.collectives import (flash_decode_attention,
                                                     grad_allreduce)
    from repro_torch.launch.group import (collectives_rank, decode_inputs,
                                          spawn_partitions)
    from repro_torch.launch.mesh import HostSimMesh
    from repro_torch.train.compression import compressed_psum_int8
    rng = np.random.default_rng(n)
    inputs = {"grad_trees": [{"w": rng.normal(0, 1, (5, 3)).astype("f4"),
                              "z": np.full(4, -0.0, np.float32)}
                             for _ in range(n)],
              "compress": [rng.normal(0, 1, (64, 48)).astype(np.float32)
                           for _ in range(n)],
              "decode": {"shape": (3, 16 * n, 4, 32), "seed": n},
              "objects": backend}
    got = spawn_partitions(collectives_rank, n, backend, ["cuda:0"] * n,
                           init_method=f"file://{tmp_path}/store",
                           args=(inputs,), timeout=120)

    def cuda(a):
        return torch.from_numpy(a).cuda()
    mean = grad_allreduce(HostSimMesh(n))(
        [{k: cuda(v) for k, v in t.items()} for t in inputs["grad_trees"]])
    comp = compressed_psum_int8([cuda(x) for x in inputs["compress"]],
                                HostSimMesh(n, "pod"))
    dec = flash_decode_attention(HostSimMesh(n, "model"), "model")(
        *decode_inputs((3, 16 * n, 4, 32), n, "cuda"))
    for r, out in enumerate(got):
        for k, v in mean.items():
            assert _bit_equal(out["grad_trees"][k], v.cpu().numpy()), k
        assert _bit_equal(out["compress"], comp.cpu().numpy())
        assert _bit_equal(out["decode"], dec.cpu().numpy())
        assert out["objects"] == [(q, backend) for q in range(n)]


# the fleet's live reconfiguration over a one-rank nccl world
LIVE_SCRIPT = [dict(bias_rate=3.0, cache_volume_mb=0.05, parallel_mode="seq",
                    workers=1, partitions=1, halo_budget=0)]
LIVE_ACFG = dict(episodes=2, steps_per_episode=2, warmup_steps=0,
                 presample=8, surrogate_trees=4, ppo_updates=1, ppo_horizon=2,
                 max_partitions=2, max_halo_budget=32, w_throughput=0.0,
                 w_memory=1.0, w_accuracy=0.0, throughput_source="modeled")


def _live_args():
    from repro_torch.launch.train import build_parser
    return build_parser().parse_args(
        ["--arch", "graphsage-products", "--smoke", "--steps", "2",
         "--episodes-autotune", "2"])


def _one_rank_live(rank, device):
    """A one-partition multi-partition trainer over the world (its mesh a
    GroupMesh of one): two global steps around ``set_halo_budget``; then
    ``autotune_rank``'s scripted 1 -> 1 episode."""
    from repro_torch.core.multipart import MultiPartitionTrainer
    from repro_torch.launch.train import autotune_rank
    cfg = gnn_config("products", **{**GROUP_CFG, "partitions": 1})
    tr = MultiPartitionTrainer(dataset_like(cfg, seed=0), cfg, seed=0,
                               device=device)
    try:
        tr.global_step()
        tr.set_halo_budget(0)
        tr.global_step()
        swap = {"mesh": tr.mesh, "budget": tr.plan.halo_budget,
                "steps": tr.global_steps,
                "losses": list(tr.slots[0].pipe.stats.losses)}
    finally:
        for s in tr.slots:
            s.pipe.shutdown()
    return {"swap": swap,
            "live": autotune_rank(rank, device, _live_args(), cfg,
                                  script=LIVE_SCRIPT,
                                  ops=[("autotune", LIVE_ACFG)])}


def test_one_rank_nccl_world_swaps_the_halo_and_autotunes(card, tmp_path):
    """``set_halo_budget`` and a scripted 1 -> 1 auto-tuner episode inside
    a one-rank ``nccl`` world (the controller's broadcasts and gathers over
    NCCL): the episode bit-equal to the same run outside a group, and the
    fused kernels launched for every step."""
    from repro_torch.kernels.build import build
    from repro_torch.launch.group import spawn_partitions
    from repro_torch.launch.mesh import GroupMesh
    from repro_torch.launch.train import autotune_rank
    build(["gather", "segment_agg", "fused_gather_agg"])
    (got,) = spawn_partitions(_one_rank_live, 1, "nccl", ["cuda:0"],
                              init_method=f"file://{tmp_path}/store",
                              timeout=120)
    swap = got["swap"]
    assert isinstance(swap["mesh"], GroupMesh) and \
        swap["mesh"].backend == "nccl" and swap["mesh"].size == 1
    assert swap["budget"] == 0 and swap["steps"] == 2
    assert len(swap["losses"]) == 1 and np.isfinite(swap["losses"]).all()
    cfg = gnn_config("products", **{**GROUP_CFG, "partitions": 1})
    want = autotune_rank(0, card, _live_args(), cfg, script=LIVE_SCRIPT,
                         ops=[("autotune", LIVE_ACFG)])
    g, w = got["live"]["ops"][0], want["ops"][0]
    assert [e["config"] for e in g["episodes"]] == \
        [e["config"] for e in w["episodes"]]
    assert g["episodes"][1]["config"]["bias_rate"] == 3.0
    for eg, ew in zip(g["episodes"], w["episodes"], strict=True):
        for key in ("cache_hit_rate", "steps", "reward"):
            assert eg[key] == ew[key], key
        assert eg["metrics"]["memory"] == ew["metrics"]["memory"]
    for a, b in zip(g["losses"], w["losses"], strict=True):
        assert _bit_equal(a, b)
    for k, v in want["state"].items():
        assert _bit_equal(got["live"]["state"][k], v), k
    # 2 episodes of 2 fused steps each
    assert got["live"]["launches"]["gather_aggregate"] == \
        want["launches"]["gather_aggregate"] == 4
    assert not {"jax", "repro"} & set(got["live"]["modules"])


# the GPipe pipeline over a stage group on the card
PIPE_SMOKE = {"stages": 2, "micro": 4, "loss": "mean", "runs": 1,
              "lm": {"arch": "llama3.2-3b", "smoke": True, "num_layers": 4,
                     "dtype": "bfloat16", "seed": 5, "x_seed": 6,
                     "micro": 4, "mb": 2, "tokens": 64}}


def test_group_pipeline_on_the_card_bit_equal_to_host_sim(card, tmp_path):
    """2 gloo ranks sharing cuda:0, each a stage of 2 of the smoke
    llama3.2-3b's 4 bf16 layers (seeded on the card), forward and the
    hand-written backward: the outputs, every gradient and the gradient of
    the microbatches bit-equal to the host-simulated pipeline on the card,
    and ``flash_attention`` and its backward launched once a layer and
    microbatch, summed over the ranks."""
    from repro_torch.kernels.build import build
    from repro_torch.launch.group import pipeline_rank, spawn_partitions
    build(["flash_attention", "flash_attention_bwd"])
    want = pipeline_rank(0, "cuda:0", PIPE_SMOKE)
    ranks = spawn_partitions(pipeline_rank, 2, "gloo", ["cuda:0", "cuda:0"],
                             init_method=f"file://{tmp_path}/store",
                             args=(PIPE_SMOKE,), timeout=120)
    n = 4 * 4
    assert want["launches"]["flash_attention"] == \
        want["launches"]["flash_attention_bwd"] == n
    summed = {k: ranks[0]["launches"][k] + ranks[1]["launches"][k]
              for k in want["launches"]}
    assert summed == want["launches"]
    seen = set()
    for got in ranks:
        for k, v in got["values"].items():
            assert v.dtype == torch.bfloat16 and _bit_equal(
                v.view(torch.int16).numpy(),
                want["values"][k].view(torch.int16).numpy()), k
            seen.add(k)
        assert not {"jax", "repro"} & set(got["modules"])
    assert seen == set(want["values"])


# ---------------------------------------------------------------------------
# flash_attention on a head shard (the sharded LM step's attention)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,Hkv,m", [(24, 8, 2), (8, 2, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_local_map_on_a_head_shard(card, H, Hkv, m, dtype):
    """``flash_attention`` of DTensors sharded on heads over an m-wide
    ``model`` axis (each rank of a fake group in turn, its shard on the
    card): the forward and dq bit-equal to the kernel on the full heads,
    sliced; dk/dv bit-equal where the kv heads are sharded alongside, and,
    where they are replicated (Hkv < m), the ranks' partial gradients
    summing to the full ones."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.kernels.build import build
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    build(["flash_attention", "flash_attention_bwd"])
    B, S, Dh = 2, 256, 128
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(B, S, h, Dh, generator=g, device="cuda")
                   .to(dtype) for h in (H, Hkv, Hkv, H))
    full = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*full)
    out.backward(do)
    hl, kv_sharded = H // m, Hkv % m == 0
    dk_sum = torch.zeros_like(k, dtype=torch.float32)
    dv_sum = torch.zeros_like(v, dtype=torch.float32)
    for r in range(m):
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=m)
        try:
            dm = DeviceMesh("cuda", torch.arange(m), mesh_dim_names=("model",))
            hs = slice(r * hl, (r + 1) * hl)
            ks = slice(r * Hkv // m, (r + 1) * Hkv // m) if kv_sharded \
                else slice(0, Hkv)
            kv_pl = [Shard(2)] if kv_sharded else [Replicate()]
            loc = [q[:, :, hs].contiguous().requires_grad_(),
                   k[:, :, ks].contiguous().requires_grad_(),
                   v[:, :, ks].contiguous().requires_grad_()]
            dq_, dk_, dv_ = (DTensor.from_local(t, dm, pl, run_check=False)
                             for t, pl in zip(loc, ([Shard(2)], kv_pl,
                                                    kv_pl)))
            f0, b0 = flash_attention.launches, flash_attention_bwd.launches
            o = flash_attention(dq_, dk_, dv_)
            assert tuple(o.placements) == (Shard(2),)
            o.to_local().backward(do[:, :, hs].contiguous())
            assert flash_attention.launches == f0 + 1
            assert flash_attention_bwd.launches == b0 + 1
        finally:
            dist.destroy_process_group()
        assert torch.equal(o.to_local(), out[:, :, hs])
        assert torch.equal(loc[0].grad, full[0].grad[:, :, hs])
        if kv_sharded:
            assert torch.equal(loc[1].grad, full[1].grad[:, :, ks])
            assert torch.equal(loc[2].grad, full[2].grad[:, :, ks])
        else:
            dk_sum += loc[1].grad.float()
            dv_sum += loc[2].grad.float()
    if not kv_sharded:
        tol = 1e-5 if dtype == torch.float32 else 2 ** -6
        for got, want in ((dk_sum, full[1].grad), (dv_sum, full[2].grad)):
            scale = float(want.float().abs().max())
            assert float((got - want.float()).abs().max()) <= tol * scale


def test_traced_step_peak_matches_the_card(card):
    """The dry-run's memory trace of an f32 llama3.2-3b train step on
    ``meta`` (``dryrun.trace_unsharded``) against the card's own window of
    the same step (``footprint.step_peak``), within
    ``footprint.peak_tolerance``: full width, cut to 1 layer and an
    8,192-token vocabulary (the full one's f32 embedding alone is 1.5
    GiB), ~1.5 GiB of parameters and AdamW state."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.footprint import (peak_tolerance, step_peak,
                                              window_start)
    from repro_torch.models.api import build
    from repro_torch.models.params import init_params
    from repro_torch.train.data import SyntheticTokens, to_device
    from repro_torch.train.trainer import make_train_step
    cfg = get_config("llama3.2-3b").replace(
        num_layers=1, vocab_size=8192, param_dtype="float32",
        compute_dtype="float32")
    B, S = 2, 256
    model = build(cfg)
    params = init_params(model.decls,
                         torch.Generator(device="cuda").manual_seed(0), card)
    step, opt = make_train_step(model, cfg)
    state = opt.init(params)
    data = SyntheticTokens(cfg.vocab_size, B, S, seed=7, n_batches=2)
    step(params, state, to_device(data.make(0), card))
    batch = to_device(data.make(1), card)
    base = window_start()
    step(params, state, batch)
    torch.cuda.synchronize()
    got = step_peak(base, params, state, batch)
    want = dryrun.trace_unsharded(cfg, ShapeConfig("t", "train", S, B))
    assert abs(want["peak_bytes"] - got) <= peak_tolerance(got), \
        (want, got)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-7b",
                                  "whisper-medium"])
def test_traced_prefill_peak_matches_the_card(card, arch):
    """A bf16 prefill, which writes its caches into one buffer allocated
    before its layer loop, against its memory trace on ``meta``
    (``dryrun.trace_unsharded``, the weights in bf16): the card's window
    of the call (``footprint.step_peak``) within
    ``footprint.peak_tolerance``.  Full width, cut to 4 layers (the
    hybrid to two shared-attention groups, the encoder-decoder to 2 + 2),
    a (2, 1024) prompt (the encoder-decoder's beside 1,500 audio
    frames)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.footprint import (peak_tolerance, step_peak,
                                              window_start)
    from repro_torch.launch.group import lm_batch
    from repro_torch.models.api import build
    from repro_torch.models.params import init_params
    cfg = get_config(arch).replace(param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    if cfg.family == "hybrid":
        cfg = cfg.replace(num_layers=2 * cfg.shared_attn_every)
    elif cfg.family == "encdec":
        cfg = cfg.replace(num_layers=2, encoder_layers=2)
    else:
        cfg = cfg.replace(num_layers=4)
    B, S = 2, 1024
    model = build(cfg)
    params = init_params(model.decls,
                         torch.Generator(device="cuda").manual_seed(0), card,
                         dtype_override=torch.bfloat16)
    batch = lm_batch({"batch": B, "seq": S}, model, "prefill", card)
    with torch.no_grad():
        model.prefill(params, batch)
        base = window_start()
        out = model.prefill(params, batch)
        torch.cuda.synchronize()
        got = step_peak(base, params, batch)
        del out
    want = dryrun.trace_unsharded(cfg, ShapeConfig("p", "prefill", S, B))
    assert abs(want["peak_bytes"] - got) <= peak_tolerance(got), \
        (want, got)
