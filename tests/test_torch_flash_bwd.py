"""paddle_tpu_torch flash attention backward and dropout.

- The plain forward and backward (`_flash_fwd_reference`,
  `_flash_bwd_reference`) and `FlashAttention`'s autograd on CPU tensors,
  at p = 0, held to the JAX package's `flash_attention_raw` under
  `jax.vjp`, its Pallas kernels in interpret mode (as
  tests/test_flash_attention.py runs them): S 128 and 256, causal or not,
  padded or not, float32, atol 1e-4 (the Pallas kernels sum over 128-wide
  tiles, the plain versions in one pass).
- Dropout (p > 0), which cannot be held to the TPU's bits: the keep mask
  is bit-exact to a pure-Python evaluation of the kernels' hash, its keep
  rate is within binomial bounds, the forward and the backward replay
  the same mask, and `_flash_bwd_reference` equals autograd through the
  dense formula with that mask (atol 1e-5, float32).
- `F.scaled_dot_product_attention` stays differentiable on every
  dispatch branch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework.flags import get_flags, set_flags
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import flash_ops as tfo

TOL = 1e-4


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = get_flags(["FLAGS_flash_attention_interpret"])
    set_flags({"FLAGS_flash_attention_interpret": True})
    old_t = tflags.get_flags(["FLAGS_flash_attention_min_seq",
                              "FLAGS_use_flash_attention"])
    tflags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    yield
    set_flags(old)
    tflags.set_flags(old_t)


def _arrays(S, seed, n=4, B=2, H=2, D=32):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(n)]


def _bias(B, S, padded):
    bias = np.zeros((B, S), np.float32)
    if padded:
        bias[1, S - 37:] = -1e30     # right-padded second sequence
    return bias


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_plain_fwd_bwd_and_autograd_match_pallas_vjp(S, causal, padded):
    q, k, v, do = _arrays(S, seed=S + 2 * causal + padded)
    bias = _bias(q.shape[0], S, padded)
    scale = 1.0 / np.sqrt(q.shape[-1])

    def jf(q_, k_, v_):
        return jpo.flash_attention_raw(q_, k_, v_, jnp.asarray(bias),
                                       jnp.zeros((), jnp.int32), causal,
                                       scale, 0.0)
    ref_o, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tb = torch.from_numpy(bias) if padded else None
    out, lse = tfo._flash_fwd_reference(tq, tk, tv, tb, causal, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), atol=TOL,
                               rtol=0)
    plain = tfo._flash_bwd_reference(tq, tk, tv, tb, out, lse, tdo, causal,
                                     scale)
    ins = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(
        tfo.flash_attention(*ins, causal=causal, scale=scale,
                            attn_mask=torch.from_numpy(bias)[:, None, None]
                            if padded else None), ins, tdo)
    for name, want, a, b in zip("qkv", ref_grads, plain, auto):
        np.testing.assert_allclose(a.numpy(), want, atol=TOL, rtol=0,
                                   err_msg=f"plain d{name}")
        np.testing.assert_allclose(b.numpy(), want, atol=TOL, rtol=0,
                                   err_msg=f"autograd d{name}")


def _py_keep(seed, bh, i, j, p):
    """The kernels' hash (flash_common.cuh) in Python integers."""
    M = 0xFFFFFFFF

    def fmix(x):
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & M
        x ^= x >> 13
        x = (x * 0xC2B2AE35) & M
        return x ^ (x >> 16)
    x = fmix(seed ^ ((bh * 0x9E3779B1) & M))
    x = fmix(x ^ ((i * 0x85EBCA77) & M))
    x = fmix(x ^ ((j * 0xC2B2AE3D) & M))
    return x >= min(int(p * 4294967296.0), M)


def test_keep_mask_is_the_kernels_hash_bit_for_bit():
    B, H, Sq, Sk, p = 2, 3, 64, 128, 0.3
    for seed in (0, 1, 2 ** 31 - 2):
        mask = tfo._keep_mask(seed, B, H, Sq, Sk, p, "cpu").numpy()
        rng = np.random.RandomState(seed % 1000)
        for _ in range(200):
            b, h = rng.randint(B), rng.randint(H)
            i, j = rng.randint(Sq), rng.randint(Sk)
            assert mask[b, h, i, j] == _py_keep(seed, b * H + h, i, j, p)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_within_binomial_bounds(p):
    B, H, S = 2, 3, 256
    masks = [tfo._keep_mask(seed, B, H, S, S, p, "cpu")
             for seed in (11, 12)]
    for m in masks:
        n = m.numel()
        sigma = np.sqrt(p * (1 - p) / n)
        assert abs(m.float().mean().item() - (1 - p)) < 6 * sigma
        # every (b, h) slab on its own, and every query row set
        per_bh = m.reshape(B * H, -1).float().mean(1).numpy()
        assert np.all(np.abs(per_bh - (1 - p))
                      < 6 * np.sqrt(p * (1 - p) / (S * S)))
    assert not torch.equal(masks[0], masks[1])
    assert torch.equal(masks[0], tfo._keep_mask(11, B, H, S, S, p, "cpu"))


def test_forward_and_backward_replay_one_mask():
    """V = I makes the forward's output the dropped probabilities; dO = I
    makes dV their transpose: both show the keep mask, and it is
    `_keep_mask` of the same seed."""
    B, H, S, p, seed = 1, 2, 128, 0.25, 77
    rng = np.random.RandomState(0)
    q, k = (torch.from_numpy(rng.standard_normal((B, H, S, S))
                             .astype(np.float32)) for _ in range(2))
    eye = torch.eye(S).expand(B, H, S, S).contiguous()
    scale = 0.05
    out, lse = tfo._flash_fwd_reference(q, k, eye, None, False, scale, p,
                                        seed)
    keep = tfo._keep_mask(seed, B, H, S, S, p, "cpu")
    assert torch.equal(out != 0, keep)
    delta = tfo._delta(out, eye)
    _, dv = tfo._dkv_reference(q, k, eye, None, eye, lse, delta, False,
                               scale, p, seed)
    assert torch.equal(dv.transpose(-1, -2) != 0, keep)


def _dense_with_mask(q, k, v, bias, causal, scale, keep, p):
    """Attention written out directly: masked softmax, then the given
    keep mask, kept probabilities scaled by 1/(1-p)."""
    s = q @ k.transpose(-1, -2) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    if causal:
        S = s.shape[-1]
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    pr = torch.softmax(s, -1)
    return (pr * keep / (1 - p)) @ v


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_bwd_reference_equals_autograd_with_the_same_mask(causal, padded):
    S, p, seed = 128, 0.2, 5
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(S, seed=3))
    bias = torch.from_numpy(_bias(2, S, padded)) if padded else None
    scale = 0.2
    out, lse = tfo._flash_fwd_reference(q, k, v, bias, causal, scale, p,
                                        seed)
    keep = tfo._keep_mask(seed, 2, 2, S, S, p, "cpu")
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    dense = _dense_with_mask(*ins, bias, causal, scale, keep, p)
    np.testing.assert_allclose(out.numpy(), dense.detach().numpy(),
                               atol=1e-5, rtol=0)
    want = torch.autograd.grad(dense, ins, do)
    got = tfo._flash_bwd_reference(q, k, v, bias, out, lse, do, causal,
                                   scale, p, seed)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0,
                                   err_msg=f"d{name}")


def test_dropout_seed_comes_from_framework_random():
    q, k, v = (torch.from_numpy(a) for a in _arrays(128, seed=8, n=3))

    def run():
        return tattn.scaled_dot_product_attention(
            q, k, v, dropout_p=0.3, is_causal=True, training=True)
    trandom.seed(4)
    a, b = run(), run()
    trandom.seed(4)
    c = run()
    assert torch.equal(a, c) and not torch.equal(a, b)
    trandom.seed(5)
    assert not torch.equal(a, run())   # another seed, another mask
    g = torch.Generator().manual_seed(9)
    d = tattn.scaled_dot_product_attention(q, k, v, dropout_p=0.3,
                                           training=True, generator=g)
    g = torch.Generator().manual_seed(9)
    e = tattn.scaled_dot_product_attention(q, k, v, dropout_p=0.3,
                                           training=True, generator=g)
    assert torch.equal(d, e)


@pytest.mark.parametrize("S,use_flash,dropout_p,expect_flash", [
    (128, True, 0.0, True),     # flash path, no dropout
    (128, True, 0.3, True),     # flash path, dropout in the Function
    (16, True, 0.0, False),     # below the gate: _sdpa_ref
    (16, True, 0.3, False),
    (128, False, 0.0, False),   # flag off: _sdpa_ref
])
def test_sdpa_differentiable_on_every_branch(monkeypatch, S, use_flash,
                                             dropout_p, expect_flash):
    tflags.set_flags({"FLAGS_use_flash_attention": use_flash})
    calls = [0]
    ref = tfo._flash_fwd_reference

    def counted(*a, **kw):
        calls[0] += 1
        return ref(*a, **kw)
    monkeypatch.setattr(tfo, "_flash_fwd_reference", counted)
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(S, seed=S))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tattn.scaled_dot_product_attention(
        *ins, dropout_p=dropout_p, is_causal=True, training=True,
        generator=torch.Generator().manual_seed(1))
    assert calls[0] == (1 if expect_flash else 0)
    grads = torch.autograd.grad(out, ins, do)
    for g in grads:
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
    if dropout_p == 0.0:
        dense = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(
            tattn._sdpa_ref(*dense, None, 1 / np.sqrt(32), True), dense, do)
        for a, b in zip(grads, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=0)


def _tf32(x):
    """cvt.rna.tf32.f32 in numpy: float32 rounded to 10 mantissa bits,
    ties away from zero (half a tf32 ulp added to the magnitude bits, the
    13 dropped bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return (((bits + 0x1000) & 0xFFFFE000).astype(np.uint32)
            .view(np.float32))


def test_3xtf32_split_holds_fp32_accuracy():
    """Why K3/K4 take three TF32 products in float32: with hi = tf32(x),
    lo = tf32(x - hi), a_lo b_hi + a_hi b_lo + a_hi b_hi (exact tf32
    products, float32 sums, as the tensor cores compute them) is within
    1e-5 x max |ref| of the float64 product, for the plain backward's dS K
    and dS^T Q at [1, 2, 256, 64]; one TF32 product errs at least 10x
    more."""
    one = np.float32(1.0)
    half_ulp = np.float32(2.0 ** -11)      # half a tf32 ulp at 1.0
    assert _tf32(one + half_ulp) == one + 2 * half_ulp      # ties away
    assert _tf32(-(one + half_ulp)) == -(one + 2 * half_ulp)
    assert _tf32(one + half_ulp / 2) == one
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(256, 9, B=1, D=64))
    scale = 0.125
    out, lse = tfo._flash_fwd_reference(q, k, v, None, True, scale)
    delta = tfo._delta(out, do)
    ds, _ = tfo._bwd_terms(q, k, v, None, do, lse, delta, True, scale, 0.0,
                           0)
    ds = ds.numpy()

    def split(x):
        hi = _tf32(x)
        return hi, _tf32(x - hi)

    for a, b in ((ds, k.numpy()),                              # dS K
                 (np.swapaxes(ds, -1, -2), q.numpy())):        # dS^T Q
        ref = a.astype(np.float64) @ b.astype(np.float64)
        (ah, al), (bh, bl) = split(a), split(b)
        three = (al @ bh + ah @ bl) + ah @ bh
        single = ah @ bh
        assert three.dtype == np.float32 and np.all(bh.view(np.uint32)
                                                    & 0x1FFF == 0)
        err3 = np.abs(three - ref).max()
        err1 = np.abs(single - ref).max()
        top = np.abs(ref).max()
        assert err3 <= 1e-5 * top, (err3, top)
        assert err1 >= 10 * err3, (err1, err3)
