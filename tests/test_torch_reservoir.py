"""The port's ``reservoir_topm`` against the JAX package's.

On the CPU the wrapper runs its plain version (``ref.py``).  It is held
against ``repro.kernels.reservoir.ops.reservoir_topm`` with the Pallas
kernel in interpret mode (``use_pallas=True``) and with the jnp oracle
(``use_pallas=False``), on the same numpy inputs: ``idx`` equal, ``keys``
within rtol 1e-6 (what the JAX test holds its own two paths to), and every
exhausted slot ``(N, -3.0e38)`` exactly.  The CUDA kernel is held against
the plain version on the card in ``test_torch_cuda.py``."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.reservoir.ops import reservoir_topm as jx_reservoir_topm
from repro_torch.kernels.reservoir.ops import chunked, layout, reservoir_topm
from repro_torch.kernels.reservoir.ref import NEG, reservoir_topm_ref

ROOT = Path(__file__).resolve().parents[1]
# (R, N, m): the shapes of tests/test_kernels.py's reservoir test, m > N,
# and a row of one lane
SHAPES = [(8, 16, 4), (13, 37, 5), (32, 200, 15), (8, 128, 25), (1, 5, 3),
          (3, 5, 9), (2, 20, 40), (4, 1, 2)]
KINDS = ["random", "all_masked_row", "ties", "u_zero"]
# ties: a few u values and two weights give exact ties; no two of the
# resulting keys are within rounding of each other
TIE_U = np.array([0.0, 0.2, 0.5, 0.7, 0.9], np.float32)


def _inputs(R, N, kind, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 4.0, (R, N)).astype(np.float32)
    u = rng.random((R, N)).astype(np.float32)
    mask = rng.random((R, N)) < 0.8
    if kind == "all_masked_row":
        mask[R // 2] = False
    elif kind == "ties":
        w = np.where(rng.random((R, N)) < 0.5, 1.0, 3.0).astype(np.float32)
        u = TIE_U[rng.integers(0, len(TIE_U), (R, N))]
    elif kind == "u_zero":
        u[rng.random((R, N)) < 0.3] = 0.0
    return w, u, mask


def _jax(w, u, mask, m, use_pallas):
    idx, keys = jx_reservoir_topm(jnp.asarray(w), jnp.asarray(u),
                                  jnp.asarray(mask), m, use_pallas=use_pallas)
    return np.asarray(idx), np.asarray(keys)


def _port(w, u, mask, m):
    launches = reservoir_topm.launches
    idx, keys = reservoir_topm(torch.from_numpy(w), torch.from_numpy(u),
                               torch.from_numpy(mask), m)
    assert reservoir_topm.launches == launches       # CPU: no kernel launch
    assert idx.dtype == torch.int32 and keys.dtype == torch.float32
    assert idx.shape == keys.shape == (w.shape[0], m)
    return idx.numpy(), keys.numpy()


def _assert_matches(idx, keys, j_idx, j_keys, w, u, mask, exact_idx):
    """``idx`` equal and ``keys`` within rtol 1e-6 of the JAX outputs, the
    exhausted slots exactly ``(N, NEG)``.  XLA's CPU ``log`` and torch's may
    differ by an ulp, which can swap two distinct keys that close; where the
    picks differ, the port's lane must carry the JAX key of the JAX pick
    (a valid top-m of the JAX keys).  ``exact_idx`` holds them equal."""
    N = w.shape[1]
    spent = j_idx == N
    assert np.array_equal(idx == N, spent)
    assert (keys[spent] == np.float32(NEG)).all()
    assert (j_keys[spent] == np.float32(NEG)).all()
    np.testing.assert_allclose(keys, j_keys, rtol=1e-6)
    if exact_idx:
        assert np.array_equal(idx, j_idx)
        return
    jk = np.asarray(jnp.log(jnp.maximum(jnp.asarray(u), 1e-30))
                    / jnp.maximum(jnp.asarray(w), 1e-9))
    r, c = np.nonzero(idx != j_idx)
    np.testing.assert_allclose(jk[r, idx[r, c]], j_keys[r, c], rtol=1e-6)
    for row, picked in zip(mask, idx):
        lanes = picked[picked < N]
        assert len(set(lanes.tolist())) == len(lanes) and row[lanes].all()


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "jnp"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("R,N,m", SHAPES)
def test_reservoir_topm_matches_jax(R, N, m, kind, use_pallas):
    w, u, mask = _inputs(R, N, kind)
    idx, keys = _port(w, u, mask, m)
    j_idx, j_keys = _jax(w, u, mask, m, use_pallas)
    _assert_matches(idx, keys, j_idx, j_keys, w, u, mask,
                    exact_idx=kind == "ties")
    if kind == "all_masked_row":
        assert (idx[R // 2] == N).all() and (keys[R // 2] == np.float32(NEG)
                                             ).all()


def test_reservoir_m_past_the_jax_padding():
    # m = 130 > 128 lanes of the JAX wrapper's padding: every round past the
    # row's valid lanes is (N, NEG) on both sides, the padded width mapped
    # back to N by the JAX wrapper
    w, u, mask = _inputs(2, 3, "all_masked_row")
    idx, keys = _port(w, u, mask, 130)
    j_idx, j_keys = _jax(w, u, mask, 130, False)
    _assert_matches(idx, keys, j_idx, j_keys, w, u, mask, exact_idx=True)
    assert (idx[:, 3:] == 3).all() and (idx[1] == 3).all()


def test_reservoir_exact_ties_go_to_the_lower_lane():
    # every lane of a row has the same key: the picks are lanes 0, 1, ...
    w = np.ones((3, 40), np.float32)
    u = np.full((3, 40), 0.5, np.float32)
    mask = np.ones((3, 40), bool)
    mask[1, :7] = False
    idx, keys = _port(w, u, mask, 6)
    for use_pallas in (True, False):
        j_idx, j_keys = _jax(w, u, mask, 6, use_pallas)
        assert np.array_equal(idx, j_idx)
        np.testing.assert_allclose(keys, j_keys, rtol=1e-6)
    assert idx.tolist() == [[0, 1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12],
                            [0, 1, 2, 3, 4, 5]]


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8, np.int8])
def test_reservoir_int_mask_equals_bool_mask(dtype):
    w, u, mask = _inputs(13, 37, "random", seed=3)
    ints = (mask * np.random.default_rng(4).integers(1, 5, mask.shape)
            ).astype(dtype)                     # nonzero values other than 1
    got = _port(w, u, ints, 7)
    want = _port(w, u, mask, 7)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    j_idx, j_keys = _jax(w, u, ints, 7, True)
    _assert_matches(*got, j_idx, j_keys, w, u, mask, exact_idx=False)


def test_reservoir_casts_other_real_types_to_float32():
    w, u, mask = _inputs(5, 30, "random", seed=5)
    got = reservoir_topm(torch.from_numpy(w).double(),
                         torch.from_numpy(u).double(), torch.from_numpy(mask),
                         4)
    want = reservoir_topm_ref(torch.from_numpy(w), torch.from_numpy(u),
                              torch.from_numpy(mask), 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_reservoir_top_by_key():
    """The selection == numpy top-m of the same ES keys (the JAX package's
    ``test_reservoir_top_by_key``, on the port)."""
    rng = np.random.default_rng(42)
    R, N, m = 6, 50, 7
    w = rng.uniform(0.5, 4.0, (R, N)).astype(np.float32)
    u = rng.random((R, N)).astype(np.float32)
    mask = rng.random((R, N)) < 0.7
    idx, _ = _port(w, u, mask, m)
    keys = np.log(np.maximum(u, 1e-30)) / np.maximum(w, 1e-9)
    keys[~mask] = -np.inf
    for r in range(R):
        nv = int(mask[r].sum())
        want = set(np.argsort(-keys[r], kind="stable")[:min(m, nv)].tolist())
        got = idx[r]
        assert want == set(got[got < N][:min(m, nv)].tolist())


def _pair_probability(w):
    """P(lane i among the 2 picks) by summing over ordered pairs: the first
    pick a with probability w_a/W, the second b with w_b/(W - w_a)."""
    W, n = sum(w), len(w)
    p = np.zeros(n)
    for a in range(n):
        for b in range(n):
            if a != b:
                pab = w[a] / W * w[b] / (W - w[a])
                p[a] += pab
                p[b] += pab
    return p


def test_reservoir_distribution_matches_exact_inclusion():
    """The plain version's per-lane inclusion frequency over 200,000 rows of
    the JAX distribution test's weights is the exact p_i (the closed form
    ``chip_smoke.py`` holds the card to) within 5 standard errors."""
    w = np.array([4, 4, 1, 1, 1, 1, 1, 1], np.float32)
    p = np.array(_chip_smoke().inclusion_probability(w.tolist()))
    np.testing.assert_allclose(p, _pair_probability(w.tolist()), rtol=1e-12)
    trials = 200_000
    u = np.random.default_rng(7).random((trials, 8)).astype(np.float32)
    idx, _ = _port(np.tile(w, (trials, 1)), u, np.ones((trials, 8), bool), 2)
    assert (idx < 8).all()
    freq = np.bincount(idx.ravel(), minlength=8) / trials
    se = np.sqrt(p * (1 - p) / trials)
    assert (np.abs(freq - p) <= 5 * se).all(), (freq, p, se)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hop_buckets_form_the_samplers_rows_and_match_jax():
    """``chip_smoke.hop_buckets`` gives each hop's top-m rows in the
    sampler's own buckets (``topm_buckets``, which ``_sample_one_hop``
    selects on): every row with more than ``fanout`` neighbours, in the
    bucket of its power-of-two width, its first ``size`` lanes valid and
    holding the bias weights of its neighbours as read from the graph; on
    those rows the port's picks equal the JAX kernel's."""
    from repro_torch.configs.gnn import gnn_config
    from repro_torch.core.cache import FeatureCache
    from repro_torch.core.locality import bias_weight_fn
    from repro_torch.core.sampling import NeighborSampler
    from repro_torch.graph.synthetic import dataset_like
    cfg = gnn_config("products", smoke=True)
    g = dataset_like(cfg, seed=0)
    weight_fn = bias_weight_fn(FeatureCache(g, 0.2, "static"), 4.0)
    seeds = np.arange(0, g.num_nodes, 7)[:64]
    mb = NeighborSampler(g, cfg.fanout, weight_fn=weight_fn,
                         seed=0).sample(seeds)
    indptr, indices = g.adj()
    rng = np.random.default_rng(0)
    n_rows = 0
    for hop, fanout in enumerate(cfg.fanout, start=1):
        dst = mb.blocks[-hop].dst_ids
        sizes = indptr[dst + 1] - indptr[dst]
        buckets = _chip_smoke().hop_buckets(g, dst, fanout, weight_fn, rng)
        big = np.where(sizes > fanout)[0]
        assert sum(len(b[1]) for b in buckets) == len(big)
        pow2 = 1 << np.ceil(np.log2(sizes[big])).astype(int)
        assert [b[0] for b in buckets] == sorted(set(pow2.tolist()))
        for width, w, u, mask in buckets:
            for row, v in zip(w, dst[big[pow2 == width]], strict=True):
                nb = indices[indptr[v]:indptr[v + 1]]
                assert np.array_equal(row[:len(nb)],
                                      weight_fn(nb).astype(np.float32))
            assert width & (width - 1) == 0 and w.shape == u.shape == (
                len(mask), width) and u.dtype == w.dtype == np.float32
            n = mask.sum(1)
            assert (n > fanout).all() and (n <= width).all() and (
                2 * n > width).all()
            assert np.array_equal(mask, np.arange(width) < n[:, None])
            assert set(np.unique(w).tolist()) <= {1.0, 4.0}
            idx, keys = _port(w, u, mask, fanout)
            j_idx, j_keys = _jax(w, u, mask, fanout, False)
            _assert_matches(idx, keys, j_idx, j_keys, w, u, mask,
                            exact_idx=False)
            n_rows += len(mask)
    assert n_rows > 0


@pytest.mark.parametrize("args,err", [
    ((torch.zeros(2, 3, dtype=torch.complex64), torch.zeros(2, 3),
      torch.ones(2, 3, dtype=torch.bool), 1), TypeError),
    ((torch.ones(2, 3, dtype=torch.bool), torch.zeros(2, 3),
      torch.ones(2, 3, dtype=torch.bool), 1), TypeError),
    ((torch.ones(2, 3), torch.zeros(2, 3), torch.ones(2, 3), 1), TypeError),
    ((torch.ones(2, 3), torch.zeros(2, 4),
      torch.ones(2, 3, dtype=torch.bool), 1), ValueError),
    ((torch.ones(6), torch.zeros(6), torch.ones(6, dtype=torch.bool), 1),
     ValueError),
    ((torch.ones(0, 3), torch.zeros(0, 3),
      torch.ones(0, 3, dtype=torch.bool), 1), ValueError),
    ((torch.ones(2, 3), torch.zeros(2, 3),
      torch.ones(2, 3, dtype=torch.bool), 0), ValueError),
    ((torch.ones(2, 3, device="meta"), torch.zeros(2, 3, device="meta"),
      torch.ones(2, 3, dtype=torch.bool, device="meta"), 1), ValueError),
])
def test_reservoir_rejects_bad_inputs(args, err):
    with pytest.raises(err):
        reservoir_topm(*args)


# ---------------------------------------------------------------------------
# chunk-then-merge: the selection the CUDA kernel makes, modelled in torch
# ---------------------------------------------------------------------------

# the chunk sizes the launcher cuts a wide row into (kernels/reservoir/ops.py
# :layout), and the widths at their borders: C - 1, C, C + 1 and 2C + 1
SPLIT_CHUNKS = sorted({layout(N).chunk_lanes for N in (4096, 16384, 32768)})
BORDERS = [(C, C + d) for C in SPLIT_CHUNKS for d in (-1, 0, 1, C + 1)]
# widths whose launcher layout splits the row over blocks (one merge level,
# two past 32 chunks)
WIDE_WIDTHS = [2049, 4097, 16385, 32769]


def _select(keys, lanes, cap):
    """The first ``cap`` candidates of each row under key descending, lane
    ascending (-inf keys last, never picked); (keys, lanes) (R, cap)."""
    o1 = torch.argsort(lanes, dim=1, stable=True)
    k1 = keys.gather(1, o1)
    order = o1.gather(1, torch.argsort(k1, dim=1, descending=True,
                                       stable=True))[:, :cap]
    k, ln = keys.gather(1, order), lanes.gather(1, order)
    pad = cap - k.shape[1]
    if pad > 0:
        k = torch.cat([k, torch.full((k.shape[0], pad), -torch.inf)], 1)
        ln = torch.cat([ln, torch.zeros((k.shape[0], pad), dtype=ln.dtype)], 1)
    return k, ln


def _merge(lists, cap):
    return _select(torch.cat([k for k, _ in lists], 1),
                   torch.cat([ln for _, ln in lists], 1), cap)


def _chunk_merge(w, u, mask, m, plan):
    """The kernel's selection in plain torch, list by list: each warp's
    32·K lanes keep their top min(m, 32·K); a chunk's W warp lists (and its
    running list, sub-chunk by sub-chunk) merge to its top min(m, lanes);
    past 32 chunks, warp w merges chunks w, w + W, ... first; the row's
    lists merge to its top m.  A narrow segment holds its whole row."""
    N = w.shape[1]
    keys = (torch.log(torch.clamp(u, min=1e-30))
            / torch.clamp(w, min=1e-9)).masked_fill(mask == 0, -torch.inf)
    lanes = torch.arange(N).expand_as(keys)
    if plan.seg:
        k, ln = _select(keys, lanes, m)
    else:
        warp, sub, span = plan.warp_lanes, plan.warp_lanes * plan.W, \
            plan.chunk_lanes
        lb = min(m, span)
        chunks = []
        for c0 in range(0, N, span):
            run = []
            for s0 in range(c0, min(c0 + span, N), sub):
                run = [_merge(run + [
                    _select(keys[:, a:a + warp], lanes[:, a:a + warp],
                            min(m, warp))
                    for a in range(s0, min(s0 + sub, N), warp)], lb)]
            chunks += run
        assert len(chunks) == plan.P
        if len(chunks) > 32:
            chunks = [_merge(chunks[i::plan.W], min(m, 32 * lb))
                      for i in range(plan.W)]
        k, ln = _merge(chunks, m)
    spent = k == -torch.inf
    return (torch.where(spent, N, ln).to(torch.int32),
            k.masked_fill(spent, NEG))


def _border_rows(N, C, seed):
    """Rows of width N for chunks of C lanes, stacked: random (80% valid);
    border ties (w = 1, the four lanes around every multiple of C and of 32
    share the row's top key); exhausted chunks (the first chunk masked
    whole, the second with 3 valid lanes, the rest 80% valid); one chunk
    (every valid lane in the last whole chunk)."""
    rng = np.random.default_rng(seed)
    w, u, mask = _inputs(4, N, "random", seed)
    w[1] = 1.0
    u[1] = rng.random(N).astype(np.float32) * 0.5
    for step in (C, 32):
        for b in range(step, N, step):
            u[1, max(b - 2, 0):b + 2] = 0.9
    mask[1] = rng.random(N) < 0.9
    mask[2, :C] = False
    mask[2, C:2 * C] = False
    three = C + np.array([1, C // 2, C - 1])
    mask[2, three[three < N]] = True
    last = max(N // C - 1, 0) * C
    mask[3] = False
    mask[3, last:last + C] = rng.random(min(C, N - last)) < 0.8
    return w, u, mask


def _plans(N, C):
    """The launcher's layout at N, the row cut into chunks of C lanes (8
    warps), one block walking it in sub-chunks of C, and chunks of 64 lanes
    (two merge levels past 32 of them)."""
    K = C // 256
    return list(dict.fromkeys([layout(N), chunked(N, K, 8, N),
                               chunked(N, K, 8, 1), chunked(N, 1, 2, N)]))


@pytest.mark.parametrize("m", [5, 40])
@pytest.mark.parametrize("C,N", BORDERS, ids=lambda v: str(v))
def test_chunk_merge_model_is_the_selection(C, N, m):
    """The invariant the kernel's exactness rests on: the top-m of a row is
    the top-m of its chunks' top-m lists, however the row is cut, with ties
    across chunk borders and exhausted chunks.  The model of the kernel's
    lists equals the port's plain version bit for bit under every layout,
    and the JAX package's selection (the jnp oracle, and the Pallas kernel
    in interpret mode) on the same rows."""
    w, u, mask = _border_rows(N, C, seed=N)
    tw, tu, tm = (torch.from_numpy(x) for x in (w, u, mask))
    want = reservoir_topm_ref(tw, tu, tm, m)
    for plan in _plans(N, C):
        got = _chunk_merge(tw, tu, tm, m, plan)
        assert torch.equal(got[0], want[0]), plan
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32)), plan
    for use_pallas in (False, True):
        j_idx, j_keys = _jax(w, u, mask, m, use_pallas)
        _assert_matches(want[0].numpy(), want[1].numpy(), j_idx, j_keys, w,
                        u, mask, exact_idx=False)


@pytest.mark.parametrize("N", WIDE_WIDTHS)
def test_chunk_merge_model_at_the_launchers_wide_layouts(N):
    """Rows the launcher splits over blocks (9 to 129 chunks; two merge
    levels at 32,769 lanes): the model of the kernel's lists against the
    JAX oracle and the plain version, m = 10."""
    plan = layout(N)
    assert plan.P > 1
    w, u, mask = _border_rows(N, plan.chunk_lanes, seed=N)
    tw, tu, tm = (torch.from_numpy(x) for x in (w, u, mask))
    got = _chunk_merge(tw, tu, tm, 10, plan)
    want = reservoir_topm_ref(tw, tu, tm, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    j_idx, j_keys = _jax(w, u, mask, 10, False)
    _assert_matches(got[0].numpy(), got[1].numpy(), j_idx, j_keys, w, u,
                    mask, exact_idx=False)


def test_launcher_layouts_cover_each_row_once():
    """Every layout the launcher picks, and every one ``chunked`` builds,
    covers a row exactly once: P chunks of S sub-chunks, the last chunk
    holding the row's last lane, at most 32·W chunks (two merge levels)."""
    for N in [1, 2, 3, 5, 8, 17, 32, 33, 64, 65, 100, 255, 256, 257, 1024,
              1025, 2048, 2049, 4096, 8193, 16385, 32768, 32769, 70217,
              131072, 2**20 + 3, 2**30]:
        plans = [layout(N)] + [chunked(N, K, W, P) for K in (1, 2, 4, 8)
                               for W in (1, 2, 4, 8) for P in (1, 7, 10**9)]
        for plan in plans:
            if plan.seg:
                assert N <= plan.seg <= 32 and plan.seg & (plan.seg - 1) == 0
                continue
            assert (plan.P - 1) * plan.chunk_lanes < N <= plan.P * \
                plan.chunk_lanes, (N, plan)
            assert 1 <= plan.P <= 32 * plan.W and plan.S >= 1
