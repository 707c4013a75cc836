"""The port's feature planes against the JAX package's on one request
stream: rows bit-exact, every mirror-sync and gather counter equal, and
the cache statistics equal, across FIFO inserts, streamed ``update_rows``
and a resize.  The port's device plane runs on a CPU device here (the
gather's plain version); the JAX device plane runs its jnp reference."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.gnn import gnn_config as jx_gnn_config
from repro.core.cache import FeatureCache as JxCache
from repro.core.feature_plane import DeviceFeaturePlane as JxDevicePlane
from repro.core.feature_plane import HostFeaturePlane as JxHostPlane
from repro.graph.storage import FeatureStore as JxStore
from repro.graph.synthetic import dataset_like as jx_dataset
from repro_torch.configs.gnn import gnn_config
from repro_torch.core.cache import FeatureCache
from repro_torch.core.feature_plane import (DeviceFeaturePlane,
                                            HostFeaturePlane,
                                            make_feature_plane)
from repro_torch.graph.storage import FeatureStore
from repro_torch.graph.synthetic import dataset_like

COUNTERS = ("gather_dispatches", "gather_rows")
SYNC_COUNTERS = ("sync_full_uploads", "sync_row_scatters",
                 "sync_rows_scattered", "sync_bytes_uploaded")


def _pair(policy, volume_mb, device_plane):
    ga = jx_dataset(jx_gnn_config("products", smoke=True), seed=0)
    gb = dataset_like(gnn_config("products", smoke=True), seed=0)
    if device_plane:
        return (JxDevicePlane(ga, JxCache(ga, volume_mb, policy)),
                DeviceFeaturePlane(gb, FeatureCache(gb, volume_mb, policy),
                                   device="cpu"))
    return (JxHostPlane(ga, JxCache(ga, volume_mb, policy)),
            HostFeaturePlane(gb, FeatureCache(gb, volume_mb, policy)))


def _same_state(a, b, device_plane):
    names = COUNTERS + (SYNC_COUNTERS if device_plane else ())
    assert {k: getattr(a, k) for k in names} == \
        {k: getattr(b, k) for k in names}
    assert dataclasses.asdict(a.cache.stats) == \
        dataclasses.asdict(b.cache.stats)


@pytest.mark.parametrize("device_plane", [False, True],
                         ids=["host", "device"])
@pytest.mark.parametrize("policy", ["static", "fifo"])
def test_plane_matches_jax_on_one_stream(policy, device_plane):
    a, b = _pair(policy, 0.2, device_plane)
    sa, sb = JxStore(a.graph), FeatureStore(b.graph)
    a.subscribe_to(sa)
    b.subscribe_to(sb)
    rng = np.random.default_rng(3)
    for step in range(8):
        # 5,000 ids: two gather chunks on the device planes
        ids = rng.integers(0, a.graph.num_nodes, 5000 if step == 2 else 300)
        assert np.array_equal(a.fetch(ids), b.fetch(ids))
        _same_state(a, b, device_plane)
        if step % 3 == 1:                    # streamed update of residents
            resident = np.where(a.cache.device_map >= 0)[0][:5]
            rows = rng.normal(0, 1, (len(resident), a.graph.feat_dim)
                              ).astype(np.float32)
            sa.update_rows(resident, rows)
            sb.update_rows(resident, rows)
            got_a, got_b = a.fetch(resident), b.fetch(resident)
            assert np.array_equal(got_a, rows) and np.array_equal(got_b, rows)
            _same_state(a, b, device_plane)
    for vol in (0.3, 0.05):                  # grow, then shrink: realloc
        a.resize(vol)
        b.resize(vol)
        ids = rng.integers(0, a.graph.num_nodes, 400)
        assert np.array_equal(a.fetch(ids), b.fetch(ids))
        _same_state(a, b, device_plane)
    if device_plane:
        assert b.device_bytes() == a.device_bytes()


def test_device_plane_mirror_is_a_copy():
    b = _pair("fifo", 0.2, True)[1]
    b.fetch(np.arange(16))
    b._ensure_synced()                       # the fetch's FIFO insert
    assert isinstance(b._dev_table, torch.Tensor)
    assert b._dev_table.data_ptr() != b.cache.storage.ctypes.data
    assert torch.equal(b._dev_table, torch.from_numpy(b.cache.storage))


def test_cacheless_device_plane_reads_the_store():
    g = dataset_like(gnn_config("products", smoke=True), seed=0)
    ids = np.arange(64)
    for cache in (None, FeatureCache(g, 0.0)):
        dev = DeviceFeaturePlane(g, cache, device="cpu")
        np.testing.assert_array_equal(dev.fetch(ids), g.features[ids])
        assert dev.device_bytes() == 0


def test_auto_follows_the_device_and_never_probes():
    g = dataset_like(gnn_config("products", smoke=True), seed=0)
    assert make_feature_plane(g, None, "auto", device="cpu").backend == "cpu"
    assert make_feature_plane(g, None, "device", device="cpu").backend == \
        "device"
    with pytest.raises(ValueError):
        make_feature_plane(g, None, "gpu0", device="cpu")
