"""The port's ``gather_aggregate`` and the feature planes' fused reads
against the JAX package's, on the same numpy inputs.

The JAX side runs ``fused_gather_agg.ops.gather_aggregate(...,
use_pallas=False)`` and its planes' jnp reference path; the port runs its
plain version on CPU tensors (the planes on a CPU device).

Tolerances: the self rows ``h_dst`` and every resolved row are bit-exact
(copies); the aggregate ``agg`` within atol = rtol = 1e-5 (f32 sums taken
in another order); plane counters and cache statistics exactly equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gnn import gnn_config as jx_gnn_config
from repro.core.cache import FeatureCache as JxCache
from repro.core.feature_plane import DeviceFeaturePlane as JxDevicePlane
from repro.core.feature_plane import HostFeaturePlane as JxHostPlane
from repro.graph.synthetic import dataset_like as jx_dataset
from repro.kernels.fused_gather_agg.ops import \
    gather_aggregate as jx_gather_aggregate
from repro.kernels.fused_gather_agg.ref import \
    resolve_rows_ref as jx_resolve_rows
from repro_torch.configs.gnn import gnn_config
from repro_torch.core.cache import FeatureCache
from repro_torch.core.feature_plane import DeviceFeaturePlane, HostFeaturePlane
from repro_torch.graph.synthetic import dataset_like
from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
from repro_torch.kernels.fused_gather_agg.ref import (gather_aggregate_ref,
                                                      resolve_rows_ref)

TOL = dict(atol=1e-5, rtol=1e-5)
COUNTERS = ("gather_dispatches", "gather_rows")
SYNC_COUNTERS = ("sync_full_uploads", "sync_row_scatters",
                 "sync_rows_scattered", "sync_bytes_uploaded")


def _case(ns, nd, fan, c, na, f, seed=7):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (c, f)).astype(np.float32)
    aux = rng.normal(0, 1, (na, f)).astype(np.float32)
    enc = np.where(rng.random(ns) < 0.6, rng.integers(0, c, ns),
                   -rng.integers(1, na + 1, ns)).astype(np.int32)
    enc[-2:] = -1                 # padded input ids resolve to aux[0]
    enc[0] = c + 3                # an out-of-range slot clamps to C − 1
    idx = rng.integers(-1, ns, (nd, fan)).astype(np.int32)
    idx[1] = -1                   # a dst row whose neighbours are all padding
    return enc, idx, table, aux


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("ns,nd,fan,c,na,f", [
    (32, 16, 5, 24, 8, 100), (9, 9, 4, 8, 3, 602), (40, 12, 10, 16, 1, 47)])
def test_gather_aggregate_matches_jax(ns, nd, fan, c, na, f, mode):
    enc, idx, table, aux = _case(ns, nd, fan, c, na, f)
    hj, aj = jx_gather_aggregate(jnp.asarray(enc), jnp.asarray(idx),
                                 jnp.asarray(table), jnp.asarray(aux),
                                 mode=mode, use_pallas=False)
    args = [torch.from_numpy(a) for a in (enc, idx, table, aux)]
    for h, a in (gather_aggregate_ref(*args, mode=mode),
                 gather_aggregate(*args, mode=mode)):
        assert h.shape == a.shape == (nd, f)
        assert np.array_equal(h.numpy(), np.asarray(hj))
        np.testing.assert_allclose(a.numpy(), np.asarray(aj), **TOL)
        assert not a.numpy()[1].any()
    rows = resolve_rows_ref(args[0], args[2], args[3]).numpy()
    assert np.array_equal(rows, np.asarray(jx_resolve_rows(
        jnp.asarray(enc), jnp.asarray(table), jnp.asarray(aux))))
    assert np.array_equal(rows[-1], aux[0])


def test_gather_aggregate_checks_and_carries_no_gradient():
    enc, idx, table, aux = (torch.from_numpy(a)
                            for a in _case(12, 6, 3, 8, 2, 5))
    launches = gather_aggregate.launches
    h, a = gather_aggregate(enc, idx, table.requires_grad_(True), aux)
    assert not h.requires_grad and not a.requires_grad
    assert gather_aggregate.launches == launches    # CPU: the plain version
    with pytest.raises(ValueError, match="mean or sum"):
        gather_aggregate(enc, idx, table, aux, mode="max")
    with pytest.raises(ValueError, match="exceed"):
        gather_aggregate(enc[:4], idx, table, aux)
    with pytest.raises(ValueError, match="at least one row"):
        gather_aggregate(enc, idx, table, aux[:0])
    with pytest.raises(TypeError, match="int32"):
        gather_aggregate(enc.long(), idx, table, aux)


def _planes(device_plane, policy, volume_mb):
    ga = jx_dataset(jx_gnn_config("products", smoke=True), seed=0)
    gb = dataset_like(gnn_config("products", smoke=True), seed=0)
    ca = JxCache(ga, volume_mb, policy) if volume_mb else None
    cb = FeatureCache(gb, volume_mb, policy) if volume_mb else None
    if device_plane:
        return JxDevicePlane(ga, ca), DeviceFeaturePlane(gb, cb, device="cpu")
    return JxHostPlane(ga, ca), HostFeaturePlane(gb, cb)


def _same_state(a, b, device_plane):
    names = COUNTERS + (SYNC_COUNTERS if device_plane
                        and b.cache is not None else ())
    assert {k: getattr(a, k) for k in names} == \
        {k: getattr(b, k) for k in names}
    if b.cache is not None:
        assert dataclasses.asdict(a.cache.stats) == \
            dataclasses.asdict(b.cache.stats)


@pytest.mark.parametrize("volume_mb", [0.2, 0.0], ids=["cache", "no-cache"])
@pytest.mark.parametrize("policy", ["static", "fifo"])
@pytest.mark.parametrize("device_plane", [False, True],
                         ids=["host", "device"])
def test_plane_fused_reads_match_jax(device_plane, policy, volume_mb):
    a, b = _planes(device_plane, policy, volume_mb)
    g = b.graph
    rng = np.random.default_rng(3)
    for step in range(4):
        n, cap = 300 + 50 * step, 512
        ids = rng.permutation(g.num_nodes)[:n]
        enc_j, aux_j, table_j = a.fused_inputs(ids, cap)
        enc_t, aux_t, table_t = b.fused_inputs(ids, cap)
        assert enc_t.dtype == torch.int32 and enc_t.shape == (cap,)
        assert np.array_equal(enc_t.numpy(), np.asarray(enc_j))
        assert np.array_equal(aux_t.numpy(), np.asarray(aux_j))
        assert table_t.shape == table_j.shape
        # the rows the step resolves are the feature store's, bit for bit
        # (the JAX table itself is not compared: on a CPU host its upload
        # of the host storage can read the storage after the FIFO insert
        # that follows the encoding, in slots this batch does not use)
        rows = resolve_rows_ref(enc_t, table_t, aux_t).numpy()
        assert np.array_equal(rows[:n], g.features[ids])
        _same_state(a, b, device_plane)

        nd = n // 3
        idx = rng.integers(-1, n, (nd, 5)).astype(np.int32)
        mode = ("mean", "sum")[step % 2]
        hj, agj = a.gather_aggregate(ids, idx, mode=mode)
        ht, agt = b.gather_aggregate(ids, idx, mode=mode)
        assert np.array_equal(ht, np.asarray(hj))
        assert np.array_equal(ht, g.features[ids[:nd]])
        np.testing.assert_allclose(agt, np.asarray(agj), **TOL)
        _same_state(a, b, device_plane)


def test_device_fused_inputs_keep_one_sideband_per_cap():
    _, b = _planes(True, "fifo", 0.2)
    ids = np.arange(400)
    _, aux1, table1 = b.fused_inputs(ids, 512)
    _, aux2, table2 = b.fused_inputs(ids[::-1].copy(), 512)
    assert aux1 is aux2                      # written in place, not reallocated
    assert table2 is b._dev_table            # the live mirror itself
    with pytest.raises(ValueError, match="exceed level cap"):
        b.fused_inputs(ids, 256)
