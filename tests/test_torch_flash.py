"""paddle_tpu_torch flash forward held to the JAX package's Pallas kernel.

The JAX side runs `pallas_ops` in interpret mode on the CPU, as
tests/test_flash_attention.py does; the port's CPU path is its plain
version (`_flash_fwd_reference`: softmax and row log-sum-exp). O and LSE are
compared, float32, atol 2e-5: the Pallas kernel sums online over tiles,
the plain version in one softmax."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework.flags import get_flags, set_flags
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.nn import functional as TFn
from paddle_tpu_torch.ops import flash_ops as tfo

TOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = get_flags(["FLAGS_flash_attention_interpret",
                     "FLAGS_use_flash_attention",
                     "FLAGS_flash_attention_min_seq"])
    set_flags({"FLAGS_flash_attention_interpret": True,
               "FLAGS_use_flash_attention": True,
               "FLAGS_flash_attention_min_seq": 128})
    old_t = tflags.get_flags("FLAGS_flash_attention_min_seq")
    tflags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    yield
    set_flags(old)
    tflags.set_flags(old_t)


def _qkv(S, seed, B=2, H=2, D=32):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(3)]


def _bias(B, S, padded):
    bias = np.zeros((B, S), np.float32)
    if padded:
        bias[1, S - 37:] = -1e30     # right-padded second sequence
    return bias


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_flash_fwd_plain_matches_pallas(S, causal, padded):
    q, k, v = _qkv(S, seed=S + 2 * causal + padded)
    bias = _bias(q.shape[0], S, padded)
    scale = 1.0 / np.sqrt(q.shape[-1])
    bq, bk = jpo._pick_blocks(S, S)
    assert tfo._pick_blocks(S, S) == (bq, bk)
    ref_o, ref_lse = jpo._flash_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        jnp.zeros((), jnp.int32), causal, scale, 0.0, bq, bk)
    launches = tfo.flash_attention_fwd.launches
    out, lse = tfo.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias) if padded else None, causal, scale)
    assert tfo.flash_attention_fwd.launches == launches   # CPU: plain path
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(ref_lse).reshape(lse.shape),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_sdpa_matches_jax_dispatch(causal, padded):
    """The port's F.scaled_dot_product_attention (plain on the CPU) vs
    the JAX one, which takes the flash kernel under interpret mode."""
    import paddle_tpu as paddle
    S = 128
    q, k, v = _qkv(S, seed=40 + causal + 2 * padded)
    mask = _bias(q.shape[0], S, padded)[:, None, None, :] if padded \
        else None
    ref = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=paddle.to_tensor(mask) if padded else None,
        is_causal=causal, training=False).numpy()
    out = TFn.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=torch.from_numpy(mask) if padded else None,
        is_causal=causal, training=False).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_sdpa_bottom_right_causal_decode_shape():
    """S < K: the query block sits at the END of the keys (KV-cache
    decode shape), the JAX fallback's bottom-right alignment."""
    rng = np.random.RandomState(9)
    q = rng.standard_normal((1, 2, 3, 8)).astype(np.float32)
    k = rng.standard_normal((1, 2, 7, 8)).astype(np.float32)
    v = rng.standard_normal((1, 2, 7, 8)).astype(np.float32)
    import paddle_tpu as paddle
    ref = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        is_causal=True, training=False).numpy()
    out = TFn.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=True, training=False).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,k_shape,causal,mask", [
    ((2, 4, 128, 32), None, True, None),
    ((2, 4, 256, 64), (2, 4, 128, 64), False, None),
    ((2, 4, 256, 64), (2, 4, 128, 64), True, None),
    ((2, 4, 100, 64), None, False, None),
    ((2, 4, 64, 64), None, False, None),
    ((2, 4, 128, 64), None, False, (2, 1, 1, 128)),
    ((2, 4, 128, 64), None, False, (2, 1, 128, 128)),
])
def test_flash_supported_gate_matches(shape, k_shape, causal, mask):
    m = np.zeros(mask, np.float32) if mask is not None else None
    assert tfo.flash_supported(shape, k_shape, mask=m, is_causal=causal) \
        == jpo.flash_supported(shape, k_shape, mask=m, is_causal=causal)


def test_sdpa_dropout_on_probabilities_is_seeded():
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 16, 8))
                                .astype(np.float32)) for _ in range(3))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return TFn.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                                training=True, generator=g)
    np.testing.assert_array_equal(run(3).numpy(), run(3).numpy())
    assert not np.array_equal(run(3).numpy(), run(4).numpy())
    # eval mode: no dropout at all
    a = TFn.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                         training=False)
    b = TFn.scaled_dot_product_attention(q, k, v)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _tiled_forward(q, k, v, bias, causal, scale, p, seed, bk):
    """Kernel K2's loop written out in torch, one 64-query tile at a time:
    key tiles of `bk`, the loop stopping at the diagonal tile when causal,
    the running max starting at -1e30, l summed before dropout, kept P
    scaled by 1/(1-p), and, for bf16 inputs, P rounded to bf16 before
    P V. Returns (out in q's type, lse [B*H, Sq])."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    keep = tfo._keep_mask(seed, B, H, Sq, Sk, p, q.device) if p else None
    out = torch.empty(B, H, Sq, D)
    lse = torch.empty(B, H, Sq)
    for q0 in range(0, Sq, 64):
        rows = slice(q0, q0 + 64)
        last = min(-(-(q0 + 64) // bk), Sk // bk) if causal else Sk // bk
        m = torch.full((B, H, 64, 1), -1e30)
        l = torch.zeros(B, H, 64, 1)
        acc = torch.zeros(B, H, 64, D)
        for t in range(last):
            keys = slice(t * bk, (t + 1) * bk)
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2) * scale
            if bias is not None:
                s = s + bias[:, None, None, keys]
            if causal:
                i = torch.arange(q0, q0 + 64)[:, None]
                j = torch.arange(t * bk, (t + 1) * bk)[None, :]
                s = torch.where(j > i, torch.tensor(-1e30), s)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(s - m_new)
            l = alpha * l + pr.sum(-1, keepdim=True)
            if keep is not None:
                pr = torch.where(keep[:, :, rows, keys], pr / (1.0 - p),
                                 torch.zeros(()))
            if q.dtype == torch.bfloat16:
                pr = pr.bfloat16().float()
            acc = alpha * acc + pr @ vf[:, :, keys]
            m = m_new
        out[:, :, rows] = acc / l
        lse[:, :, rows] = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse.reshape(B * H, Sq)


@pytest.mark.parametrize("bk", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_online_softmax_matches_plain(bk, causal, p, dtype):
    """K2's tiled online softmax (see `_tiled_forward`) against
    `_flash_fwd_reference` on the same inputs and keep mask. The second
    sequence's bias masks a tail of its keys; non-causal, it masks every
    key of the first sequence, whose rows must come out uniform (the mean
    of V), as the plain version's. Tolerance: fp32 1e-5 (summation
    order); bf16 1e-2 x max(1, max |ref|) (P rounded to bf16 before P V,
    the output to bf16); LSE 1e-5 in both."""
    B, H, S, D = 2, 2, 192, 32
    rng = np.random.RandomState(bk + causal + int(10 * p))
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, S, D))
                                .astype(np.float32)).to(dtype)
               for _ in range(3))
    bias = torch.zeros(B, S)
    bias[1, 150:] = -1e30
    if not causal:
        bias[0] = -1e30
    scale = 0.2
    got, got_lse = _tiled_forward(q, k, v, bias, causal, scale, p, 5, bk)
    want, want_lse = tfo._flash_fwd_reference(q, k, v, bias, causal, scale,
                                              p, 5)
    tol = 1e-5 if dtype == torch.float32 else \
        1e-2 * max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(got_lse, want_lse, atol=1e-5, rtol=0)
    if not causal:
        mean = v[0].float().mean(-2, keepdim=True)
        if p == 0.0:
            torch.testing.assert_close(got[0].float(), mean.expand_as(
                got[0]).to(dtype).float(), atol=tol, rtol=0)
