"""The port's ``cache_gather`` against the JAX package's.

On the CPU the wrapper runs its plain version; it is held bit-exact
against ``repro.kernels.gather.ops.cache_gather(..., use_pallas=False)``
(the jnp oracle) over the shapes of the JAX package's gather contract
test.  The CUDA kernel itself is held against the plain version on the
card in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather.ops import cache_gather as jx_cache_gather
from repro_torch.kernels.gather.ops import cache_gather

CASES = [(37, 16, 602), (5, 8, 300), (3, 4, 700), (100, 32, 602)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, C, F, seed=0):
    rng = np.random.default_rng(seed)
    cache = rng.normal(0, 1, (C, F)).astype(np.float32)
    slots = rng.integers(-1, C, n).astype(np.int32)
    return slots, cache


@pytest.mark.parametrize("n,C,F", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cache_gather_matches_jax_bit_exact(n, C, F, dtype):
    jdt, tdt = DTYPES[dtype]
    slots, cache = _inputs(n, C, F)
    o_ref, m_ref = jx_cache_gather(jnp.asarray(slots),
                                   jnp.asarray(cache).astype(jdt),
                                   use_pallas=False)
    cache_t = torch.from_numpy(cache).to(tdt)
    launches = cache_gather.launches
    out, miss = cache_gather(torch.from_numpy(slots), cache_t)
    assert cache_gather.launches == launches        # CPU: no kernel launch
    assert out.shape == (n, F) and miss.shape == (n,)
    assert out.dtype == tdt and miss.dtype == torch.int32
    assert np.array_equal(out.float().numpy(), np.asarray(o_ref, np.float32))
    assert np.array_equal(miss.numpy(), np.asarray(m_ref))
    assert np.array_equal(miss.numpy(), slots < 0)


def test_cache_gather_clamps_out_of_range_slots_like_jax():
    slots = np.array([0, 9, -1, 3], np.int32)          # 9 >= C
    cache = np.arange(12, dtype=np.float32).reshape(4, 3)
    o_ref, m_ref = jx_cache_gather(jnp.asarray(slots), jnp.asarray(cache),
                                   use_pallas=False)
    out, miss = cache_gather(torch.from_numpy(slots), torch.from_numpy(cache))
    assert np.array_equal(out.numpy(), np.asarray(o_ref))
    assert np.array_equal(miss.numpy(), np.asarray(m_ref))


@pytest.mark.parametrize("slots,cache,err", [
    (torch.zeros(4, dtype=torch.int64), torch.zeros(2, 3), TypeError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(2, 3, dtype=torch.float64),
     TypeError),
    (torch.zeros(4, 1, dtype=torch.int32), torch.zeros(2, 3), ValueError),
    (torch.zeros(0, dtype=torch.int32), torch.zeros(2, 3), ValueError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(0, 3), ValueError),
])
def test_cache_gather_rejects_bad_inputs(slots, cache, err):
    with pytest.raises(err):
        cache_gather(slots, cache)
