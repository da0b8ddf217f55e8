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
- K5's tiling: the (warp band, key tile) pairs `_uniform_tiles` sends
  down the mask-free path hold only allowed pairs, and are exactly the
  visited ones that do; K5's loop written out in torch (`_tiled_forward`)
  equals `_splash_fwd_reference` (fp32 atol 1e-5, bf16 1e-2 x max(1,
  max |ref|)) and, fp32 at p 0, the JAX package's splash forward.
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


# -- the 16x8 sub-tile rule in the layout of K6 and K7 -------------------------

def _pairs(mask, transposed):
    """A [B, S/16, S/8] sub-tile mask as a [B, 1, Sq, Sk] pair mask."""
    m = mask.repeat_interleave(16, 1).repeat_interleave(8, 2)
    return (m.transpose(1, 2) if transposed else m)[:, None]


def _random_layouts(seed, B=4, S=512):
    """Non-decreasing ids: segments of 1-15 tokens (a boundary in most
    16x8 sub-tiles), of 1-200 tokens, one segment, and a row whose kv
    ids skip some of the query ids."""
    rng = np.random.RandomState(seed)
    rows = []
    for hi in (16, 201):
        lens = rng.randint(1, hi, size=S)
        rows.append(np.repeat(np.arange(S), lens)[:S])
    rows.append(np.zeros(S, np.int64))
    rows.append(np.sort(rng.randint(0, 9, size=S)))
    return torch.from_numpy(np.stack(rows[:B]).astype(np.int32))


def _bench_first_pack():
    """The ids of the packing bench's first pack: the first 64 of its
    clipped-lognormal lengths (bench.py:2351-2353, seed 7, T 1024) packed
    first-fit into `suggest_rows` rows (headroom 1.15)."""
    from paddle_tpu_torch import io
    T = 1024
    rng = np.random.RandomState(7)
    lengths = np.clip(np.round(np.exp(rng.normal(
        np.log(T / 6.0), 0.9, 2048))).astype(int), 4, T)
    rows = io.suggest_rows(lengths, 64, T, headroom=1.15)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # a sequence may not fit
        pack = io.PackingCollator(T, rows)(
            [np.zeros(L, np.int64) for L in lengths[:64]])
    return torch.from_numpy(pack[1])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("ids", ["random", "bench_pack"])
def test_subtiles_cover_every_allowed_pair(ids, causal):
    """Every allowed (q, k) pair lies in a live 16x8 sub-tile of K6's
    layout and of K7's (`_subtile_mask`), and the rule finds work to skip:
    on the bench's first pack fewer sub-tiles are live than the kernels'
    tiles hold."""
    seg = _random_layouts(3) if ids == "random" else _bench_first_pack()
    allowed = tso._allowed(seg, seg, causal)
    for transposed in (False, True):
        visited, live = tso._subtile_mask(seg, seg, causal, transposed)
        assert not (allowed & ~_pairs(live, transposed)).any()
        assert (live <= visited).all()
        if ids == "bench_pack":
            share = int(live.sum()) / int(visited.sum())
            assert 0.0 < share < 1.0, share


def _tiled_grads(q, k, v, seg, do, lse, delta, causal, scale, p, seed,
                 tile):
    """dQ, dK and dV in K6's and K7's loops, written out in torch, with the
    16x8 sub-tile skip: the kernels' tile loops over `_block_bounds`'
    spans (64-row units, walked in tiles of `tile` keys or queries), P
    computed (with the per-element segment test) only on the sub-tiles
    `_subtile_mask` marks live and 0 elsewhere, dS and Pd rounded to q's
    type before the second products as the kernels round them in bf16."""
    B, H, S, D = q.shape
    f32 = [t.float() for t in (q, k, v, do)]
    qf, kf, vf, dof = f32
    allowed = tso._allowed(seg, seg, causal)
    keep = (tfo._keep_mask(seed, B, H, S, S, p, "cpu") if p > 0
            else torch.ones(B, H, S, S, dtype=torch.bool))
    lse = lse.reshape(B, H, S, 1)
    delta = delta.reshape(B, H, S, 1)
    kv_lo, kv_hi, q_lo, q_hi = tso._block_bounds(seg, seg, 64, 64, causal)

    def terms(transposed, rows, cols):
        _, live = tso._subtile_mask(seg, seg, causal, transposed)
        ok = _pairs(live, transposed) & allowed
        s = qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2) * scale
        pr = torch.where(ok[:, :, rows, cols], torch.exp(s - lse[:, :, rows]),
                         0.0)
        dp = dof[:, :, rows] @ vf[:, :, cols].transpose(-1, -2)
        kp = keep[:, :, rows, cols]
        dp = torch.where(kp, dp / (1.0 - p), 0.0)
        pd = torch.where(kp, pr / (1.0 - p), 0.0)
        ds = pr * (dp - delta[:, :, rows])
        return ds.to(q.dtype).float(), pd.to(q.dtype).float()

    dq = torch.zeros(B, H, S, D)
    dk = torch.zeros(B, H, S, D)
    dv = torch.zeros(B, H, S, D)
    per = 64 // tile
    for b in range(B):
        for i in range(S // 64):                 # K6: a query tile
            rows = slice(64 * i, 64 * i + 64)
            for t in range(int(kv_lo[b, i]) * per, int(kv_hi[b, i]) * per):
                cols = slice(tile * t, tile * t + tile)
                ds, _ = terms(False, rows, cols)
                dq[b, :, rows] += ds[b] @ kf[b, :, cols]
        for j in range(S // 64):                 # K7: a key tile
            cols = slice(64 * j, 64 * j + 64)
            for t in range(int(q_lo[b, j]) * per, int(q_hi[b, j]) * per):
                rows = slice(tile * t, tile * t + tile)
                ds, pd = terms(True, rows, cols)
                dk[b, :, cols] += ds[b].transpose(-1, -2) @ qf[b, :, rows]
                dv[b, :, cols] += pd[b].transpose(-1, -2) @ dof[b, :, rows]
    return [(g * m).to(q.dtype) for g, m in ((dq, scale), (dk, scale),
                                             (dv, 1.0))]


_JAX_VJP = {}


def _jax_vjp(q, k, v, do, seg, causal, scale):
    """The JAX package's splash_attention_raw VJP (Pallas kernels in
    interpret mode), once per causal setting."""
    if causal not in _JAX_VJP:
        def jf(q_, k_, v_):
            return jso.splash_attention_raw(
                q_, k_, v_, jnp.asarray(seg), jnp.asarray(seg),
                jnp.zeros((), jnp.int32), causal, scale, 0.0)
        _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
        _JAX_VJP[causal] = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    return _JAX_VJP[causal]


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_subtile_grads_match_reference(dtype, causal, p, tile):
    """Skipping the sub-tiles that are not live keeps the function: dQ/dK/dV
    that compute only the live ones (`_tiled_grads`) equal the plain
    `_splash_dq_reference` / `_splash_dkv_reference` on the same inputs,
    ids and keep mask (fp32 atol 1e-5, summation order; bf16 1e-2 x
    max(1, max |ref|), one rounding of dS and Pd), and, in fp32 at p 0,
    the JAX package's splash_attention VJP (GRAD_TOL, as above). Ids:
    SEG_LAYOUTS' rows plus a boundary-heavy row."""
    B, H, S, D = 3, 2, 256, 32
    q, k, v, do = _arrays((B, H, S, D), 40 + causal, 4)
    seg_np = np.stack([_segments(S, b) for b in SEG_LAYOUTS[0]]
                      + [np.repeat(np.arange(S), np.random.RandomState(
                          9).randint(1, 16, size=S))[:S]]).astype(np.int32)
    seg = torch.from_numpy(seg_np)
    tq, tk, tv, tdo = (t.to(dtype) for t in _t(q, k, v, do))
    scale, seed = 1.0 / D ** 0.5, 23
    out, lse = tso._splash_fwd_reference(tq, tk, tv, seg, seg, causal, scale,
                                         p, seed)
    delta = tfo._delta(out, tdo)
    args = (tq, tk, tv, seg, seg, tdo, lse, delta, causal, scale, p, seed)
    want = [tso._splash_dq_reference(*args),
            *tso._splash_dkv_reference(*args)]
    got = _tiled_grads(tq, tk, tv, seg, tdo, lse, delta, causal, scale, p,
                       seed, tile)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype
        top = max(1.0, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * top, f"d{name}: {err:.3e} > {tol} x {top:.3e}"
    if dtype == torch.float32 and p == 0.0:
        for name, a, b in zip("qkv", got, _jax_vjp(q, k, v, do, seg_np,
                                                     causal, scale)):
            np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=f"d{name}")


def test_kernel_ids_must_be_16_byte_aligned():
    """K5-K7 copy segment ids in 16-byte pieces: the launch check
    refuses ids that do not start on a 16-byte boundary (a view into a
    larger buffer), and takes ids that do."""
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    B, H, S = 2, 1, 128
    q = torch.zeros(B, H, S, 32)
    bounds = (torch.zeros(B, S // 64, dtype=torch.int32),) * 2
    seg = torch.zeros(B, S, dtype=torch.int32)
    tso._check_ids(q, seg, seg, bounds)
    shifted = torch.zeros(B * S + 1, dtype=torch.int32)[1:].view(B, S)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(InvalidArgumentError, match="16-byte"):
        tso._check_ids(q, shifted, seg, bounds)


# -- K5's tiling: key tiles over the spans, the mask-free path ------------------

def _edge_rows(S=256):
    """Segment edges at 16-row boundaries (16, 64, 128, 224) and between
    them (40, 100, 248), and a row whose edges all fall mid-band."""
    return np.stack([_segments(S, (16, 40, 64, 100, 128, 224, 248)),
                     _segments(S, (8, 70, 150, 233))]).astype(np.int32)


def _tiling_layout(ids):
    """[B, S] int32 ids: one segment a row, the packing bench's first pack,
    a boundary-heavy row (as test_tiled_subtile_grads_match_reference
    builds it), or _edge_rows."""
    S = 256
    if ids == "one":
        return torch.zeros(2, S, dtype=torch.int32)
    if ids == "bench_pack":
        return _bench_first_pack()
    if ids == "boundaries":
        return torch.from_numpy(np.repeat(np.arange(S), np.random.RandomState(
            9).randint(1, 16, size=S))[:S].astype(np.int32)[None])
    return torch.from_numpy(_edge_rows(S))


def _blocks(mask, key_tile):
    """A [B, S/16, S/key_tile] band-by-tile mask as a [B, S, S] pair mask."""
    return mask.repeat_interleave(16, 1).repeat_interleave(key_tile, 2)


@pytest.mark.parametrize("key_tile", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("ids", ["one", "bench_pack", "boundaries", "edges"])
def test_uniform_tiles_hold_only_allowed_pairs(ids, causal, key_tile):
    """Every pair of a (warp band, key tile) that `_uniform_tiles` marks is
    allowed, and the rule misses none: the marked ones are exactly the
    visited ones whose every pair is allowed. On one segment a row and on
    edges at 16-row boundaries the mask-free path is taken."""
    seg = _tiling_layout(ids)
    B, S = seg.shape
    visited, uniform = tso._uniform_tiles(seg, seg, causal, key_tile)
    assert uniform.shape == (B, S // 16, S // key_tile)
    assert (uniform <= visited).all()
    allowed = tso._allowed(seg, seg, causal)[:, 0]
    assert not (_blocks(uniform, key_tile) & ~allowed).any()
    whole = ~(~allowed).reshape(B, S // 16, 16, S // key_tile,
                                key_tile).any(4).any(2)
    assert torch.equal(uniform, visited & whole)
    if ids in ("one", "edges"):
        assert uniform.any()
    if ids == "one" and not causal:
        assert torch.equal(uniform, visited)


def _tiled_forward(q, k, v, seg, causal, scale, p, seed, tile):
    """K5's loop written out in torch: for each 64-query tile, the key
    tiles of `tile` keys over its `_block_bounds` span (64-key units); for
    each warp band of 16 queries an online softmax across those tiles,
    the per-element segment test only where `_uniform_tiles` does not mark
    the (band, tile) pair, P zeroed by the test, l summed before dropout,
    P rounded to q's type before P V (as the kernel rounds it in bf16),
    O = acc / l_safe and LSE = m + log(l_safe)."""
    B, H, S, D = q.shape
    qf, kf, vf = (t.float() for t in (q, k, v))
    allowed = tso._allowed(seg, seg, causal)[:, 0]
    keep = tfo._keep_mask(seed, B, H, S, S, p, "cpu") if p > 0 else None
    kv_lo, kv_hi = tso._block_bounds(seg, seg, 64, 64, causal)[:2]
    _, uniform = tso._uniform_tiles(seg, seg, causal, tile)
    out = torch.zeros(B, H, S, D)
    lse = torch.zeros(B, H, S)
    per = 64 // tile
    for b in range(B):
        for w in range(S // 16):
            rows = slice(16 * w, 16 * w + 16)
            m = torch.full((H, 16, 1), -1e30)
            l = torch.zeros(H, 16, 1)
            acc = torch.zeros(H, 16, D)
            for t in range(int(kv_lo[b, w // 4]) * per,
                           int(kv_hi[b, w // 4]) * per):
                cols = slice(tile * t, tile * t + tile)
                s = qf[b, :, rows] @ kf[b, :, cols].transpose(-1, -2) * scale
                ok = None if uniform[b, w, t] else allowed[b, rows, cols]
                if ok is not None:
                    s = torch.where(ok, s, -1e30)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                pr = torch.exp(s - m_new)
                if ok is not None:
                    pr = torch.where(ok, pr, 0.0)
                l = alpha * l + pr.sum(-1, keepdim=True)
                if keep is not None:
                    pr = torch.where(keep[b, :, rows, cols], pr / (1.0 - p),
                                     0.0)
                acc = alpha * acc + pr.to(q.dtype).float() @ vf[b, :, cols]
                m = m_new
            l_safe = torch.where(l > 0, l, 1.0)
            out[b, :, rows] = acc / l_safe
            lse[b, :, rows] = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse.reshape(B * H, S)


_JAX_FWD = {}


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_forward_matches_reference(dtype, causal, p, tile):
    """K5's tiling keeps the function: `_tiled_forward` (key tiles of 32 or
    64 over the spans, the mask-free path where `_uniform_tiles` says, P
    rounded to bf16 in bf16) equals `_splash_fwd_reference` on the same
    inputs, ids and keep mask (fp32 atol 1e-5, summation order; bf16 1e-2
    x max(1, max |ref|), one rounding of P and of O; LSE atol 1e-5 in
    both) and, fp32 at p 0, the JAX package's splash_attention_raw
    forward (Pallas in interpret mode; GRAD_TOL). Ids: SEG_LAYOUTS' rows,
    a boundary-heavy row and _edge_rows, so both paths run."""
    B, H, S, D = 5, 2, 256, 32
    q, k, v = _arrays((B, H, S, D), 50 + causal, 3)
    seg_np = np.concatenate([
        np.stack([_segments(S, b) for b in SEG_LAYOUTS[0]]),
        _tiling_layout("boundaries").numpy(), _edge_rows(S)])
    seg = torch.from_numpy(seg_np)
    visited, uniform = tso._uniform_tiles(seg, seg, causal, tile)
    assert 0 < int(uniform.sum()) < int(visited.sum())
    tq, tk, tv = (t.to(dtype) for t in _t(q, k, v))
    scale, seed = 1.0 / D ** 0.5, 31
    got, got_lse = _tiled_forward(tq, tk, tv, seg, causal, scale, p, seed,
                                  tile)
    want, want_lse = tso._splash_fwd_reference(tq, tk, tv, seg, seg, causal,
                                               scale, p, seed)
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    top = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * top, f"O: {err:.3e} > {tol} x {top:.3e}"
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5,
                               rtol=0)
    if dtype == torch.float32 and p == 0.0:
        if causal not in _JAX_FWD:
            _JAX_FWD[causal] = np.asarray(jso.splash_attention_raw(
                *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(seg_np),
                jnp.asarray(seg_np), jnp.zeros((), jnp.int32), causal, scale,
                0.0))
        np.testing.assert_allclose(got.numpy(), _JAX_FWD[causal],
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
