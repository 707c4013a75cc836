"""The port's numpy data layer is a copy of the JAX package's: at a fixed
seed the graph, the sampled mini-batches and the cache state must be
bit-identical to ``repro``'s."""
import dataclasses

import numpy as np
import pytest

from repro.configs.gnn import gnn_config as jx_gnn_config
from repro.core.cache import FeatureCache as JxCache
from repro.core.locality import bias_weight_fn as jx_bias
from repro.core.sampling import NeighborSampler as JxSampler
from repro.core.sampling import seed_loader as jx_seed_loader
from repro.graph.batch import batch_device_arrays as jx_arrays
from repro.graph.batch import compute_level_caps as jx_caps
from repro.graph.synthetic import dataset_like as jx_dataset
from repro_torch.configs.gnn import gnn_config
from repro_torch.core.cache import FeatureCache
from repro_torch.core.locality import bias_weight_fn
from repro_torch.core.sampling import NeighborSampler, seed_loader
from repro_torch.graph.batch import batch_device_arrays, compute_level_caps
from repro_torch.graph.synthetic import dataset_like

GRAPH_ARRAYS = ("indptr", "indices", "features", "labels", "train_mask",
                "val_mask", "test_mask")


@pytest.fixture(scope="module")
def graphs():
    return (jx_dataset(jx_gnn_config("products", smoke=True), seed=0),
            dataset_like(gnn_config("products", smoke=True), seed=0))


def test_config_matches():
    a = dataclasses.asdict(jx_gnn_config("products", smoke=True))
    b = dataclasses.asdict(gnn_config("products", smoke=True))
    assert a == b


@pytest.mark.parametrize("seed", [0, 3])
def test_dataset_like_bit_identical(seed):
    a = jx_dataset(jx_gnn_config("products", smoke=True), seed=seed)
    b = dataset_like(gnn_config("products", smoke=True), seed=seed)
    assert a.name == b.name
    for name in GRAPH_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("policy", ["static", "fifo"])
def test_cache_slots_and_stats_bit_identical(graphs, policy):
    ga, gb = graphs
    ca, cb = JxCache(ga, 0.2, policy), FeatureCache(gb, 0.2, policy)
    rng = np.random.default_rng(1)
    for _ in range(4):
        ids = rng.integers(0, ga.num_nodes, 300)
        assert np.array_equal(ca.fetch(ids), cb.fetch(ids))
        assert np.array_equal(ca.device_map, cb.device_map)
        assert np.array_equal(ca.slot_owner, cb.slot_owner)
        assert np.array_equal(ca.storage, cb.storage)
        assert dataclasses.asdict(ca.stats) == dataclasses.asdict(cb.stats)
        assert (ca.version, ca.epoch) == (cb.version, cb.epoch)


@pytest.mark.parametrize("gamma", [1.0, 4.0])
def test_minibatches_bit_identical(graphs, gamma):
    ga, gb = graphs
    cfg = gnn_config("products", smoke=True)
    ca, cb = JxCache(ga, 0.2), FeatureCache(gb, 0.2)
    sa = JxSampler(ga, cfg.fanout, seed=5,
                   weight_fn=jx_bias(ca, gamma) if gamma > 1 else None)
    sb = NeighborSampler(gb, cfg.fanout, seed=5,
                         weight_fn=bias_weight_fn(cb, gamma) if gamma > 1
                         else None)
    batches = zip(jx_seed_loader(ga, cfg.batch_size, 2),
                  seed_loader(gb, cfg.batch_size, 2))
    for i, (xa, xb) in enumerate(batches):
        if i == 3:
            break
        assert np.array_equal(xa, xb)
        ma, mb = sa.sample(xa), sb.sample(xb)
        assert np.array_equal(ma.input_ids, mb.input_ids)
        assert np.array_equal(ma.labels, mb.labels)
        for ba, bb in zip(ma.blocks, mb.blocks, strict=True):
            assert np.array_equal(ba.src_ids, bb.src_ids)
            assert np.array_equal(ba.dst_ids, bb.dst_ids)
            assert np.array_equal(ba.neigh_idx, bb.neigh_idx)
        caps = compute_level_caps(len(xa), cfg.fanout, ga.num_nodes)
        assert caps == jx_caps(len(xa), cfg.fanout, ga.num_nodes)
        ma.features = ga.features[ma.input_ids]
        mb.features = gb.features[mb.input_ids]
        aa, ab = jx_arrays(ma), batch_device_arrays(mb)
        assert aa["pads"] == ab["pads"]
        assert np.array_equal(aa["features"], ab["features"])
        for x, y in zip(aa["neigh_idxs"], ab["neigh_idxs"], strict=True):
            assert np.array_equal(x, y)
