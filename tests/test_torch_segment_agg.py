"""The port's ``neighbor_agg`` (forward and backward) against the JAX
package's ``segment_agg`` oracle, on the same numpy inputs.

The JAX side runs ``ops.neighbor_agg(..., use_pallas=False)`` and
``jax.vjp`` of it (the Pallas path is forward-only).  The port runs its
plain versions (``ref.py``) and its ``torch.autograd.Function`` on CPU
tensors, which takes those plain versions.

Tolerance: atol = rtol = 1e-5 (f32 sums of at most ten terms taken in
another order).  The order contract of the CUDA backward (ascending flat
entry id per source row) is held bit-equal to the plain version here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_agg.ops import neighbor_agg as jx_neighbor_agg
from repro_torch.kernels.segment_agg.ops import (neighbor_agg,
                                                 neighbor_agg_backward,
                                                 neighbor_mean)
from repro_torch.kernels.segment_agg.ref import (neighbor_agg_bwd_ref,
                                                 neighbor_agg_ref)
from test_torch_cuda import SKEWED, _skewed

TOL = dict(atol=1e-5, rtol=1e-5)
# (Nd, Ns, fanout, D): a hop of the smoke model, the JAX contract's odd
# shape (D=602), GAT's last-hop width (D=47) and a wide fanout
SHAPES = [(32, 64, 5, 24), (9, 20, 4, 602), (16, 40, 10, 47),
          (7, 7, 15, 8)]
MODES = ["mean", "sum", "weighted"]


def _inputs(nd, ns, fan, d, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, ns, (nd, fan)).astype(np.int32)
    idx[1] = -1                                  # a row that is all padding
    h = rng.normal(0, 1, (ns, d)).astype(np.float32)
    w = rng.uniform(0, 1, (nd, fan)).astype(np.float32)
    dout = rng.normal(0, 1, (nd, d)).astype(np.float32)
    return idx, h, w, dout


def _call_args(mode, w):
    return ("sum", w) if mode == "weighted" else (mode, None)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_jax(shape, mode):
    idx, h, w, _ = _inputs(*shape)
    m, wj = _call_args(mode, w)
    want = np.asarray(jx_neighbor_agg(
        jnp.asarray(idx), jnp.asarray(h), mode=m,
        weights=None if wj is None else jnp.asarray(wj), use_pallas=False))
    wt = None if wj is None else torch.from_numpy(wj)
    ti, th = torch.from_numpy(idx), torch.from_numpy(h)
    ref = neighbor_agg_ref(ti, th, m, wt).numpy()
    got = neighbor_agg(ti, th, m, wt).numpy()
    np.testing.assert_allclose(ref, want, **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[1].any()                      # all-padding row → 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_jax_vjp(shape, mode):
    idx, h, w, dout = _inputs(*shape, seed=1)
    m, wj = _call_args(mode, w)
    if wj is None:
        _, vjp = jax.vjp(lambda hh: jx_neighbor_agg(
            jnp.asarray(idx), hh, mode=m, use_pallas=False), jnp.asarray(h))
        (dh_j,), dw_j = vjp(jnp.asarray(dout)), None
    else:
        _, vjp = jax.vjp(lambda hh, ww: jx_neighbor_agg(
            jnp.asarray(idx), hh, mode=m, weights=ww, use_pallas=False),
            jnp.asarray(h), jnp.asarray(wj))
        dh_j, dw_j = vjp(jnp.asarray(dout))
    ti, td = torch.from_numpy(idx), torch.from_numpy(dout)
    wt = None if wj is None else torch.from_numpy(wj)

    dh_r, dw_r = neighbor_agg_bwd_ref(ti, td, torch.from_numpy(h), m, wt)
    th = torch.from_numpy(h).requires_grad_(True)
    wa = None if wt is None else wt.clone().requires_grad_(True)
    out = neighbor_agg(ti, th, m, wa)
    grads = torch.autograd.grad(out, [th] + ([wa] if wa is not None else []),
                                td)
    for got in (dh_r, grads[0]):
        np.testing.assert_allclose(got.numpy(), np.asarray(dh_j), **TOL)
    if dw_j is None:
        assert dw_r is None
    else:
        for got in (dw_r, grads[1]):
            np.testing.assert_allclose(got.numpy(), np.asarray(dw_j), **TOL)
        assert not dw_r.numpy()[idx < 0].any()  # padded entries: zero


def test_weights_with_mode_mean_raise():
    idx, h, w, dout = (torch.from_numpy(a) for a in _inputs(4, 8, 3, 5))
    with pytest.raises(ValueError, match="mode='sum'"):
        neighbor_agg(idx, h, "mean", w)
    with pytest.raises(ValueError, match="mode='sum'"):
        neighbor_agg_ref(idx, h, "mean", w)
    with pytest.raises(ValueError, match="mode='sum'"):
        neighbor_agg_backward(idx, dout, h, "mean", w)
    with pytest.raises(ValueError, match="unknown aggregation mode"):
        neighbor_agg(idx, h, "max")


def test_cpu_tensors_take_the_plain_version():
    idx, h, w, dout = (torch.from_numpy(a) for a in _inputs(6, 9, 4, 7))
    fwd, bwd = neighbor_agg.launches, neighbor_agg_backward.launches
    hh = h.clone().requires_grad_(True)
    out = neighbor_agg(idx, hh, "sum", w)
    out.backward(dout)
    assert torch.equal(out.detach(), neighbor_agg_ref(idx, h, "sum", w))
    assert torch.equal(neighbor_mean(idx, h), neighbor_agg_ref(idx, h))
    # no kernel ran, so no launch was counted
    assert (neighbor_agg.launches, neighbor_agg_backward.launches) == \
        (fwd, bwd)


def test_shape_and_dtype_checks():
    idx, h, w, _ = (torch.from_numpy(a) for a in _inputs(4, 8, 3, 5))
    with pytest.raises(TypeError, match="int32"):
        neighbor_agg(idx.long(), h)
    with pytest.raises(ValueError, match="must match"):
        neighbor_agg(idx, h, "sum", w[:, :2])
    with pytest.raises(ValueError, match="Ns >= 1"):
        neighbor_agg(idx, h[:0])


# ---------------------------------------------------------------------------
# the order contract of the CUDA backward
# ---------------------------------------------------------------------------

def _scaled_rows(idx, dout, mode, w):
    """(source of each valid entry, g of each) in ascending flat entry id e,
    rounded as the plain version rounds g."""
    mask = idx >= 0
    r, f = np.nonzero(mask)                       # row-major: ascending e
    cnt = np.maximum(mask.sum(1), 1).astype(np.float32)
    if mode == "mean":
        g = dout[r] / cnt[r, None]
    elif w is not None:
        g = dout[r] * w[r, f][:, None]
    else:
        g = dout[r]
    return idx[r, f], g.astype(np.float32)


def _pull_by_source(src, g, ns):
    """dh pulled per source row, as the CUDA backward orders it: the entries
    grouped by source, each source's in ascending e, added one at a time
    from 0 (np.add.at applies them in the order given)."""
    dh = np.zeros((ns, g.shape[1]), np.float32)
    order = np.argsort(src, kind="stable")        # by source, then by e
    np.add.at(dh, src[order], g[order])
    return dh


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", SKEWED)
def test_backward_order_contract(kind, mode):
    # the plain version's index_add_ adds in ascending flat entry id, so an
    # np.add.at of g in that order, and a pull per source row in that order
    # (the CUDA kernels' order), are bit-equal to it; both are within 1e-5
    # of jax.vjp of the JAX oracle
    idx, ns, d = _skewed(kind)
    rng = np.random.default_rng(1)
    h = rng.normal(0, 1, (ns, d)).astype(np.float32)
    dout = rng.normal(0, 1, (idx.shape[0], d)).astype(np.float32)
    w = rng.uniform(0, 1, idx.shape).astype(np.float32)
    m, wj = _call_args(mode, w)
    wt = None if wj is None else torch.from_numpy(wj)
    dh_r, _ = neighbor_agg_bwd_ref(torch.from_numpy(idx), torch.from_numpy(dout),
                                   torch.from_numpy(h), m, wt)
    src, g = _scaled_rows(idx, dout, m, wj)
    src = np.minimum(src, ns - 1)
    at = np.zeros((ns, d), np.float32)
    np.add.at(at, src, g)
    pulled = _pull_by_source(src, g, ns)
    assert np.array_equal(at.view(np.int32), dh_r.numpy().view(np.int32))
    assert np.array_equal(pulled.view(np.int32), dh_r.numpy().view(np.int32))
    # JAX's forward reads row Ns - 1 for an index past Ns, but its vjp (a
    # scatter) drops that entry; the port's backward is the gradient of the
    # clamped forward, so the oracle is given the clamped indices
    jidx = jnp.asarray(np.where(idx >= 0, np.minimum(idx, ns - 1), idx))
    if wj is None:
        _, vjp = jax.vjp(lambda hh: jx_neighbor_agg(
            jidx, hh, mode=m, use_pallas=False), jnp.asarray(h))
    else:
        _, vjp = jax.vjp(lambda hh: jx_neighbor_agg(
            jidx, hh, mode=m, weights=jnp.asarray(wj), use_pallas=False),
            jnp.asarray(h))
    (dh_j,) = vjp(jnp.asarray(dout))
    np.testing.assert_allclose(dh_r.numpy(), np.asarray(dh_j), **TOL)
