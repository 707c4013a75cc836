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
