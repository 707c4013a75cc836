"""The port's ``flash_attention`` (its CPU path: the plain version) against
the JAX package's, on the same numpy inputs.

The JAX side runs ``flash_attention(use_pallas=True, interpret=True)`` (the
Pallas kernel in interpret mode; it needs no ``pl.load`` and runs under the
installed jax) and ``use_pallas=False`` (its jnp oracle).  Shapes the JAX
wrapper refuses (S not a multiple of its block) are held against its
``attention_ref``; GQA against JAX with kv repeated, as the model repeats it.

Tolerances: f32 atol 2e-5, rtol 1e-4 (the JAX kernel test's: an online
softmax in f32 against the exact one); bf16 atol 3e-2 (outputs rounded to
bf16, |out| ≲ 2).  The CUDA kernel's bf16 outputs are held to the tighter,
output-scaled ``bf16_excess``, itself checked here against the kernel's
arithmetic and two faults."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jx_flash
from repro.kernels.flash_attention.ref import attention_ref as jx_ref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     bf16_excess,
                                                     flash_attention_ref)

F32 = dict(atol=2e-5, rtol=1e-4)


def _qkv(B, S, H, Dh, Hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    Hkv = Hkv or H
    return (rng.normal(0, 1, (B, S, H, Dh)).astype(np.float32),
            rng.normal(0, 1, (B, S, Hkv, Dh)).astype(np.float32),
            rng.normal(0, 1, (B, S, Hkv, Dh)).astype(np.float32))


def _port(q, k, v, causal, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return flash_attention(*t, causal=causal).float().numpy()


# (S, Dh, H, causal): the shapes of the JAX package's kernel test
@pytest.mark.parametrize("S,Dh,H,causal", [(128, 64, 2, True),
                                           (256, 128, 1, True),
                                           (128, 128, 3, False),
                                           (512, 64, 2, True)])
@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas_interpret", "jnp"])
def test_matches_jax(S, Dh, H, causal, use_pallas):
    q, k, v = _qkv(2, S, H, Dh)
    want = jx_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, use_pallas=use_pallas, interpret=True)
    np.testing.assert_allclose(_port(q, k, v, causal), np.asarray(want),
                               **F32)


def test_bf16_matches_jax():
    q, k, v = _qkv(1, 256, 2, 64)
    want = jx_flash(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                    use_pallas=True, interpret=True)
    got = flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                            for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("S", [1, 37, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_any_length_matches_jax_ref(S, causal):
    q, k, v = _qkv(1, S, 2, 16, seed=S)

    def fold(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(-1, S, 16)
    want = np.asarray(jx_ref(fold(q), fold(k), fold(v), causal=causal))
    want = want.reshape(1, 2, S, 16).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_port(q, k, v, causal), want, **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_matches_jax_with_kv_repeated(causal):
    q, k, v = _qkv(2, 128, 4, 32, Hkv=2, seed=5)
    rep = [jnp.repeat(jnp.asarray(a), 2, axis=2) for a in (k, v)]
    want = jx_flash(jnp.asarray(q), *rep, causal=causal, use_pallas=True,
                    interpret=True)
    np.testing.assert_allclose(_port(q, k, v, causal), np.asarray(want),
                               **F32)


def test_plain_versions_agree():
    # the (B, S, H, Dh) plain version is attention_ref on folded heads
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 40, 3, 16, seed=9))
    got = flash_attention_ref(q, k, v)
    fold = [x.transpose(1, 2).reshape(6, 40, 16) for x in (q, k, v)]
    want = attention_ref(*fold).reshape(2, 3, 40, 16).transpose(1, 2)
    assert got.is_contiguous()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _kernel_arithmetic(q, k, v, drop=(0, 0, 0), scale=(0, 1.0)):
    """The bf16 kernel's arithmetic in plain torch (causal): f32 scores and
    normaliser, P rounded to bf16 before P.V, the output rounded to bf16.
    ``drop = (row, lo, hi)`` removes keys lo:hi from the rows from ``row``
    on (a skipped KV tile); ``scale = (row, c)`` multiplies the rows from
    ``row`` on by c (a wrong normaliser)."""
    B, S, H, Dh = q.shape
    G = H // k.shape[2]
    kf, vf = (x.float().repeat_interleave(G, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * Dh ** -0.5
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    keep[drop[0]:, drop[1]:drop[2]] = False
    s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), vf)
    out = out / p.sum(-1).transpose(1, 2)[..., None]
    out[:, scale[0]:] *= scale[1]
    return out.bfloat16()


# the bf16 bound of the CUDA kernel's check passes its rounding and refuses
# a kernel that skips one KV tile of the last query block, or gets the
# normaliser of the later rows 3% wrong
@pytest.mark.parametrize("fault,agrees", [
    ({}, True), (dict(drop=(448, 128, 192)), False),
    (dict(scale=(256, 1.03)), False)],
    ids=["rounded_p", "skipped_tile", "normaliser_3pct"])
def test_bf16_bound_separates_rounding_from_faults(fault, agrees):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 512, 4, 64, Hkv=2, seed=3))
    elem, row = bf16_excess(_kernel_arithmetic(q, k, v, **fault), q, k, v)
    assert (max(elem, row) <= 1) == agrees, (elem, row)


def test_cpu_tensor_takes_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 2, 16))
    launches = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == launches


@pytest.mark.parametrize("bad", ["heads", "dtype", "mixed", "rank", "shape"])
def test_contract_is_checked(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 16, Hkv=2))
    if bad == "heads":
        k, v = k[:, :, :1].expand(1, 16, 3, 16), v[:, :, :1].expand(1, 16, 3, 16)
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "rank":
        q = q[0]
    else:
        v = v[:, :8]
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v)


# the widths the card kernels run on a wider template (Dh 8 on the 16-wide
# instance, 112 on the 128-wide one): glm4-9b's smoke config (H 8, Hkv 2)
# and the zamba2-7b / kimi-k2 heads, GQA, causal and not, odd lengths;
# held against the JAX model's ``_attend`` with kv repeated and the scale
# of the real width
@pytest.mark.parametrize("B,S,H,Hkv,Dh", [(2, 64, 8, 2, 8), (1, 37, 4, 4, 8),
                                         (1, 70, 4, 4, 112),
                                         (2, 33, 8, 2, 112)])
@pytest.mark.parametrize("causal", [True, False])
def test_wider_template_widths_match_jax_attend(B, S, H, Hkv, Dh, causal):
    q, k, v = _qkv(B, S, H, Dh, Hkv=Hkv, seed=Dh + S)
    rep = [jnp.repeat(jnp.asarray(a), H // Hkv, axis=2) for a in (k, v)]
    mask = (lambda qi, ki: qi[:, None] >= ki[None, :]) if causal else None
    want = JL._attend(jnp.asarray(q), *rep, mask, Dh ** -0.5)
    np.testing.assert_allclose(_port(q, k, v, causal), np.asarray(want),
                               **F32)


def test_head_dims_contract():
    # every width a served config gives the prefill is taken on the card:
    # glm4-9b's smoke Dh 8, the 16-128 power-of-two widths (whisper-medium's
    # 64 and qwen2-vl-2b's 128 among them), zamba2-7b's and kimi-k2's 112;
    # each is a multiple of 8, so the tensor maps' strides (Dh·2 and
    # H·Dh·2 bytes) stay multiples of 16, and each runs on the narrowest of
    # the 16/32/64/128 templates that holds it
    from repro_torch.configs import ModelConfig, get_config, list_archs
    from repro_torch.kernels.flash_attention.ops import TEMPLATE_WIDTH
    assert HEAD_DIMS == (8, 16, 32, 64, 112, 128) == tuple(TEMPLATE_WIDTH)
    assert all(d % 8 == 0 and d <= 128 for d in HEAD_DIMS)
    assert TEMPLATE_WIDTH == {d: min(w for w in (16, 32, 64, 128) if w >= d)
                              for d in HEAD_DIMS}
    served = 0
    for arch in list_archs():
        for smoke in (False, True):
            cfg = get_config(arch, smoke=smoke)
            if isinstance(cfg, ModelConfig) and cfg.family != "ssm":
                assert cfg.head_dim in HEAD_DIMS, (arch, smoke, cfg.head_dim)
                served += 1
    assert served == 18         # 9 archs with attention, full and smoke
