"""paddle_tpu_torch splash attention held to paddle_tpu's.

- `SplashAttention` on CPU tensors (the plain versions of K5-K7) against
  the JAX package's `splash_attention_raw` under `jax.vjp`, its Pallas
  kernels in interpret mode (as tests/test_splash_attention.py runs
  them), on that file's segment layouts (boundaries off the tile grid):
  forward rtol/atol 2e-5, gradients 5e-4 (float32; the Pallas kernels sum
  over tiles, the plain versions in one pass).
- `_block_bounds` at tiles 64 (the CUDA kernels') and 128: equal to the
  JAX function's at the same tile, and covering the brute-force span.
- Rows whose segment is absent from kv are exactly zero; all-zero ids
  give flash attention (1e-6).
- Dropout cannot be held to the TPU's bits (ROADMAP C2): the plain
  forward, dQ and dK/dV replay one keep mask (equal to autograd through
  the forward with that mask, atol 1e-5) and its keep rate is within
  binomial bounds.
- The dispatch: `splash_supported`, STAT_splash_dispatches, the dense
  fallback, the attn_mask exclusivity, the non-monotonic raise, and the
  reference's positional contract (`name` 8th, `segment_ids` 9th).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.flags import get_flags, set_flags
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.ops import splash_ops as jso
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import flash_ops as tfo
from paddle_tpu_torch.ops import splash_ops as tso

FWD_TOL = 2e-5
GRAD_TOL = 5e-4

# rows mixing segment counts, boundaries off the 128-tile grid
# (tests/test_splash_attention.py:74-77)
SEG_LAYOUTS = [
    [(37, 150, 201), (113,)],
    [(5, 130, 140, 250), ()],
]


@pytest.fixture(autouse=True)
def _splash_at_128():
    old = get_flags(["FLAGS_flash_attention_interpret",
                     "FLAGS_use_splash_attention",
                     "FLAGS_splash_attention_min_seq"])
    set_flags({"FLAGS_flash_attention_interpret": True,
               "FLAGS_use_splash_attention": True,
               "FLAGS_splash_attention_min_seq": 128})
    old_t = tflags.get_flags(["FLAGS_use_splash_attention",
                              "FLAGS_splash_attention_min_seq"])
    tflags.set_flags({"FLAGS_splash_attention_min_seq": 128})
    yield
    set_flags(old)
    tflags.set_flags(old_t)


def _arrays(shape, seed, n):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _segments(S, boundaries):
    seg = np.zeros((S,), np.int32)
    for b in boundaries:
        seg[b:] += 1
    return seg


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", SEG_LAYOUTS)
def test_forward_and_gradients_match_pallas(causal, layout):
    B, H, S, D = len(layout), 2, 256, 32
    q, k, v, do = _arrays((B, H, S, D), 1 + causal, 4)
    seg = np.stack([_segments(S, b) for b in layout])
    scale = 1.0 / D ** 0.5

    def jf(q_, k_, v_):
        return jso.splash_attention_raw(q_, k_, v_, jnp.asarray(seg),
                                        jnp.asarray(seg),
                                        jnp.zeros((), jnp.int32), causal,
                                        scale, 0.0)
    ref_o, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    ref_g = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    ins = [t.requires_grad_() for t in _t(q, k, v)]
    tseg = torch.from_numpy(seg)
    out = tso.SplashAttention.apply(*ins, tseg, tseg, 0, causal, scale, 0.0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_o),
                               rtol=FWD_TOL, atol=FWD_TOL)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(do))
    for name, a, b in zip("qkv", grads, ref_g):
        np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")
    dense = tso.sdpa_segment_reference(*_t(q, k, v), tseg, tseg, causal,
                                       scale)
    want = jso.sdpa_segment_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                      jnp.asarray(seg), jnp.asarray(seg),
                                      causal, scale)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want),
                               rtol=FWD_TOL, atol=FWD_TOL)


def _brute_spans(q_seg, kv_seg, bq, bk, causal):
    """The key-tile span each query tile needs, from the full mask."""
    B, Sq = q_seg.shape
    Sk = kv_seg.shape[1]
    allowed = q_seg[:, :, None] == kv_seg[:, None, :]
    if causal:
        allowed &= np.tril(np.ones((Sq, Sk), bool))[None]
    spans = np.zeros((B, Sq // bq, 2), np.int64)
    for b in range(B):
        for i in range(Sq // bq):
            cols = np.flatnonzero(allowed[b, i * bq:(i + 1) * bq].any(0))
            if len(cols):
                spans[b, i] = (cols[0] // bk, cols[-1] // bk + 1)
    return spans


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tile", [64, 128])
def test_block_bounds_match_jax_and_cover(tile, causal):
    S = 512
    seg = np.stack([_segments(S, (37, 150, 201, 430)),
                    _segments(S, (250, 260)), _segments(S, ())])
    got = [t.numpy() for t in tso._block_bounds(
        torch.from_numpy(seg), torch.from_numpy(seg), tile, tile, causal)]
    want = [np.asarray(a) for a in jso._block_bounds(
        jnp.asarray(seg), jnp.asarray(seg), tile, tile, causal)]
    for name, a, b in zip(("kv_lo", "kv_hi", "q_lo", "q_hi"), got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=name)
    kv_lo, kv_hi, q_lo, q_hi = got
    spans = _brute_spans(seg, seg, tile, tile, causal)
    assert (kv_lo <= spans[:, :, 0]).all() and (kv_hi >= spans[:, :, 1]).all()
    # the transpose: every key tile's query span covers its needed queries
    spans_t = _brute_spans(seg, seg, tile, tile, False)
    if causal:
        assert (q_lo >= np.arange(S // tile)[None]).all()
    else:
        assert (q_lo <= spans_t[:, :, 0]).all()
        assert (q_hi >= spans_t[:, :, 1]).all()
    assert int((kv_hi - kv_lo).sum()) < seg.shape[0] * (S // tile) ** 2


def test_absent_segment_rows_are_zero():
    """A query whose segment exists nowhere in kv outputs exactly 0 (the
    TPU kernel's l_safe rule), gets LSE -1e30, and a zero dQ row; the
    other rows match the Pallas kernel."""
    B, H, S, D = 1, 2, 256, 32
    q, k, v, do = _arrays((B, H, S, D), 13, 4)
    q_seg = _segments(S, (100, 180))[None]          # 0, 1, 2
    kv_seg = q_seg.copy()
    kv_seg[kv_seg == 1] = 0                         # kv has no segment 1
    tq, tk, tv, tdo = _t(q, k, v, do)
    qs, ks = torch.from_numpy(q_seg), torch.from_numpy(kv_seg)
    out, lse = tso._splash_fwd_reference(tq, tk, tv, qs, ks, False, 0.2)
    absent = torch.from_numpy(q_seg[0] == 1)
    assert (out[:, :, absent] == 0).all()
    assert (lse.reshape(B, H, S)[:, :, absent] == -1e30).all()
    want = jso.splash_attention_raw(*(jnp.asarray(a) for a in (q, k, v)),
                                    jnp.asarray(q_seg), jnp.asarray(kv_seg),
                                    jnp.zeros((), jnp.int32), False, 0.2,
                                    0.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    dq = tso._splash_dq_reference(tq, tk, tv, qs, ks, tdo, lse,
                                  tfo._delta(out, tdo), False, 0.2)
    assert torch.isfinite(dq).all() and (dq[:, :, absent] == 0).all()
    # whole rows of ids that kv never holds
    out2, _ = tso._splash_fwd_reference(
        tq, tk, tv, torch.full((B, S), 5, dtype=torch.int32),
        torch.full((B, S), 7, dtype=torch.int32), False, 0.2)
    assert (out2 == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_all_zero_ids_equal_flash(causal):
    B, H, S, D = 2, 2, 256, 32
    tq, tk, tv = _t(*_arrays((B, H, S, D), 10, 3))
    seg = torch.zeros(B, S, dtype=torch.int32)
    o_s, lse_s = tso._splash_fwd_reference(tq, tk, tv, seg, seg, causal, 0.2)
    o_f, lse_f = tfo._flash_fwd_reference(tq, tk, tv, None, causal, 0.2)
    np.testing.assert_allclose(o_s.numpy(), o_f.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(lse_s.numpy(), lse_f.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_mask_replayed_by_fwd_dq_dkv(causal):
    B, H, S, D, p, seed = 2, 2, 128, 32, 0.2, 77
    q, k, v, do = _arrays((B, H, S, D), 20 + causal, 4)
    seg = torch.from_numpy(np.stack([_segments(S, (30, 90)),
                                     _segments(S, (64,))]))
    ins = [t.requires_grad_() for t in _t(q, k, v)]
    tdo = torch.from_numpy(do)
    out, lse = tso._splash_fwd_reference(*ins, seg, seg, causal, 0.3, p,
                                         seed)
    auto = torch.autograd.grad(out, ins, tdo)
    plain_in = [t.detach() for t in ins]
    delta = tfo._delta(out.detach(), tdo)
    args = (seg, seg, tdo, lse.detach(), delta, causal, 0.3, p, seed)
    dq = tso._splash_dq_reference(*plain_in, *args)
    dk, dv = tso._splash_dkv_reference(*plain_in, *args)
    for name, a, b in zip("qkv", (dq, dk, dv), auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0,
                                   err_msg=f"d{name}")
    fn = [t.detach().clone().requires_grad_() for t in ins]
    got = torch.autograd.grad(
        tso.SplashAttention.apply(*fn, seg, seg, seed, causal, 0.3, p), fn,
        tdo)
    for a, b in zip(got, auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    # statistics: the keep rate over the allowed pairs
    keep = tfo._keep_mask(seed, B, H, S, S, p, "cpu")
    allowed = tso._allowed(seg, seg, causal).expand_as(keep)
    n = int(allowed.sum())
    rate = float(keep[allowed].float().mean())
    assert abs(rate - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)


def test_splash_supported_gates():
    for shape in [(2, 2, 256, 32), (2, 2, 512, 64), (1, 4, 1024, 128),
                  (2, 2, 200, 32)]:
        assert tso.splash_supported(shape, min_seq=128) == \
            jso.splash_supported(shape, min_seq=128), shape
    assert not tso.splash_supported((2, 2, 256, 32), min_seq=512)
    assert not tso.splash_supported((2, 2, 256, 32), (2, 2, 128, 32),
                                    (2, 2, 128, 32), min_seq=128)
    # head dims the CUDA kernels are not built for
    assert not tso.splash_supported((2, 2, 256, 16), min_seq=128)
    assert not tso.splash_supported((2, 2, 256, 12), min_seq=128)
    tflags.set_flags({"FLAGS_splash_attention_min_seq": 512})
    assert not tso.splash_supported((2, 2, 256, 32))
    assert tso.splash_supported((2, 2, 512, 32))


@pytest.mark.parametrize("causal", [False, True])
def test_functional_dispatch_matches_jax(causal):
    B, H, S, D = 2, 2, 256, 32
    q, k, v = _arrays((B, H, S, D), 16, 3)
    seg = np.stack([_segments(S, (100,)), _segments(S, (37, 201))])
    n0 = monitor.stat_get("STAT_splash_dispatches")
    out = tattn.scaled_dot_product_attention(*_t(q, k, v),
                                             is_causal=causal,
                                             segment_ids=seg)
    assert monitor.stat_get("STAT_splash_dispatches") == n0 + 1
    want = JF.scaled_dot_product_attention(
        *(JTensor(jnp.asarray(a)) for a in (q, k, v)), is_causal=causal,
        segment_ids=JTensor(jnp.asarray(seg)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want._value),
                               rtol=FWD_TOL, atol=FWD_TOL)
    # a (q_seg, kv_seg) pair of tensors takes the same path
    out2 = tattn.scaled_dot_product_attention(
        *_t(q, k, v), is_causal=causal,
        segment_ids=(torch.from_numpy(seg), torch.from_numpy(seg)))
    assert monitor.stat_get("STAT_splash_dispatches") == n0 + 2
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


@pytest.mark.parametrize("why", ["min_seq", "flag_off"])
def test_functional_dense_fallback_matches_jax(why):
    """Below FLAGS_splash_attention_min_seq, or with splash off, the dense
    segment-masked fallback: same numbers, no splash dispatch."""
    if why == "min_seq":
        tflags.set_flags({"FLAGS_splash_attention_min_seq": 512})
    else:
        tflags.set_flags({"FLAGS_use_splash_attention": False})
    set_flags({"FLAGS_splash_attention_min_seq": 512})
    B, H, S, D = 1, 2, 128, 16
    q, k, v = _arrays((B, H, S, D), 19, 3)
    seg = np.stack([_segments(S, (50, 90))])
    n0 = monitor.stat_get("STAT_splash_dispatches")
    out = tattn.scaled_dot_product_attention(*_t(q, k, v), is_causal=True,
                                             segment_ids=seg)
    assert monitor.stat_get("STAT_splash_dispatches") == n0
    want = JF.scaled_dot_product_attention(
        *(JTensor(jnp.asarray(a)) for a in (q, k, v)), is_causal=True,
        segment_ids=JTensor(jnp.asarray(seg)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want._value),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_sdpa_positional_contract():
    """ROADMAP C5: `name` is the 8th positional parameter and
    `segment_ids` the 9th, as in the JAX package
    (tests/test_splash_attention.py:286-295); generator and scale are
    keyword-only."""
    q = _arrays((1, 1, 128, 8), 30, 1)[0]
    out = tattn.scaled_dot_product_attention(*_t(q, q, q), None, 0.0, False,
                                             True, "attn1")
    want = JF.scaled_dot_product_attention(
        *(JTensor(jnp.asarray(q)) for _ in range(3)), None, 0.0, False,
        True, "attn1")
    assert tuple(out.shape) == (1, 1, 128, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(want._value),
                               rtol=FWD_TOL, atol=FWD_TOL)
    seg = _segments(128, (40,))[None]
    out = tattn.scaled_dot_product_attention(*_t(q, q, q), None, 0.0, True,
                                             True, "attn1", seg)
    want = JF.scaled_dot_product_attention(
        *(JTensor(jnp.asarray(q)) for _ in range(3)), None, 0.0, True,
        True, "attn1", JTensor(jnp.asarray(seg)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want._value),
                               rtol=FWD_TOL, atol=FWD_TOL)
    with pytest.raises(TypeError):
        tattn.scaled_dot_product_attention(*_t(q, q, q), None, 0.0, False,
                                           True, None, None, None)


def test_segment_ids_exclusive_with_attn_mask():
    q = torch.zeros(1, 1, 128, 8)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tattn.scaled_dot_product_attention(
            q, q, q, attn_mask=torch.zeros(1, 1, 1, 128),
            segment_ids=torch.zeros(1, 128, dtype=torch.int32))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_non_monotonic_segment_ids_rejected(as_tensor):
    seg_bad = np.asarray([[0, 1, 0, 1] * 32], np.int32)
    if as_tensor:
        seg_bad = torch.from_numpy(seg_bad)
    q = torch.zeros(1, 1, 128, 32)
    with pytest.raises(ValueError, match="NON-DECREASING"):
        tso.splash_attention(q, q, q, seg_bad, seg_bad)
