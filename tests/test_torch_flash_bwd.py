"""The backward of the port's ``flash_attention`` on the CPU (its plain
version, ``flash_attention_bwd_ref``, and the ``FlashAttention`` autograd
Function around the forward) against ``jax.vjp`` of the JAX package's
attention, on the same numpy inputs.

JAX has no backward kernel: its model differentiates jnp attention
(``layers._attend_seq``, kv repeated), and its kernel package's oracle is
``attention_ref`` (heads folded into the batch).  Both are held here, across
causal and full attention, GQA groups of 1, 2 and 4, ragged lengths and
head widths 8, 16, 64 and 112.  Tolerance: 1e-5 absolute plus 1e-5
relative, f32 throughout (two f32 summation orders of the same gradient).
The card's kernel is held against ``flash_attention_bwd_ref`` in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jx_ref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(37, 8), (64, 16), (100, 64), (130, 112)]      # (S, Dh)


def _inputs(B, S, H, Hkv, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, S, H, Dh)).astype(np.float32),
            rng.normal(0, 1, (B, S, Hkv, Dh)).astype(np.float32),
            rng.normal(0, 1, (B, S, Hkv, Dh)).astype(np.float32),
            rng.normal(0, 1, (B, S, H, Dh)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("S,Dh", SHAPES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bwd_ref_matches_vjp_of_jax_attention_ref(S, Dh, causal):
    """Heads folded into the batch: JAX's (BH, S, Dh) oracle is the port's
    (1, S, BH, Dh) with one kv head per q head."""
    q, k, v, do = _inputs(3, S, 1, 1, Dh)
    fold = [a[:, :, 0] for a in (q, k, v, do)]                 # (BH, S, Dh)
    out, vjp = jax.vjp(lambda q, k, v: jx_ref(q, k, v, causal=causal),
                       *(jnp.asarray(a) for a in fold[:3]))
    want = vjp(jnp.asarray(fold[3]))
    tq, tk, tv, tdo = (t.permute(2, 1, 0, 3).contiguous()      # (1, S, BH, Dh)
                       for t in _t(q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, causal, with_lse=True)
    np.testing.assert_allclose(o[0].permute(1, 0, 2).numpy(), np.asarray(out),
                               atol=2e-5, rtol=1e-4)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].permute(1, 0, 2).numpy(),
                                   np.asarray(w), **TOL)


@pytest.mark.parametrize("S,Dh", SHAPES)
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa2", "gqa4"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_function_backward_matches_vjp_of_jax_attend_seq(S, Dh, H, Hkv,
                                                         causal):
    """The model's attention: JAX's ``_attend_seq`` (kv repeated, jnp)
    differentiated by ``jax.vjp``, against ``flash_attention`` through its
    autograd Function on the CPU (GQA by index, dK/dV summed over the
    group)."""
    q, k, v, do = _inputs(2, S, H, Hkv, Dh, seed=S + Dh)
    cfg = SimpleNamespace(head_dim=Dh, attn_chunk=0)
    out, vjp = jax.vjp(lambda q, k, v: JL._attend_seq(q, k, v, cfg, causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = flash_attention(tq, tk, tv, causal)
    assert o.grad_fn is not None
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               atol=2e-5, rtol=1e-4)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_gqa_sums_the_group_in_ascending_head_order():
    """dK and dV of a kv head are the sums, head by head in ascending order,
    of the group's q heads' gradients (each from the repeated-kv backward),
    bit for bit."""
    q, k, v, do = _t(*_inputs(2, 50, 6, 2, 16, seed=3))
    o, lse = flash_attention_ref(q, k, v, True, with_lse=True)
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, True)
    kr, vr = (t.repeat_interleave(3, dim=2) for t in (k, v))
    _, dkr, dvr = flash_attention_bwd_ref(q, kr, vr, o, lse, do, True)
    for grouped, per_head in ((dk, dkr), (dv, dvr)):
        want = per_head[:, :, 0::3] + per_head[:, :, 1::3]
        want = want + per_head[:, :, 2::3]
        assert torch.equal(grouped, want)


def test_function_forward_is_the_plain_forward_and_counts_nothing():
    q, k, v, do = _t(*_inputs(1, 40, 4, 2, 16, seed=4))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    plain = flash_attention(q, k, v, True)
    assert plain.grad_fn is None
    tq = q.clone().requires_grad_()
    o = flash_attention(tq, k, v, True)
    assert torch.equal(o.detach(), plain)
    assert torch.equal(plain, flash_attention_ref(q, k, v, True))
    torch.autograd.grad(o, tq, do)
    with torch.no_grad():                      # grad off: no Function
        assert flash_attention(tq, k, v, True).grad_fn is None
    # launches count kernel launches: none on the CPU
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


@pytest.mark.parametrize("bad", ["lse_shape", "lse_dtype", "do_shape",
                                 "o_dtype"])
def test_bwd_refuses_bad_inputs(bad):
    q, k, v, do = _t(*_inputs(1, 20, 4, 2, 8))
    o, lse = flash_attention_ref(q, k, v, True, with_lse=True)
    if bad == "lse_shape":
        lse = lse[:, :, :-1]
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "do_shape":
        do = do[:, :-1]
    else:
        o = o.double()
    with pytest.raises((ValueError, TypeError)):
        flash_attention_bwd(q, k, v, o, lse, do, True)
