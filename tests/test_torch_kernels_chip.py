"""The port's CUDA kernels against their plain versions, on the card.

Marked `chip`: they skip where there is no CUDA device (the CPU suite)
and run on the GPU with

    python -m pytest --noconftest -m chip tests/test_torch_kernels_chip.py

(`--noconftest`: the repository's conftest configures JAX, which the
GPU machine does not have). Small shapes; chip_smoke.py checks the main
paths' shapes."""
import pytest
import torch

from paddle_tpu_torch.ops import flash_ops, paged_ops

pytestmark = pytest.mark.chip


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("case", ["edges", "long"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128, 80, 96, 256])
def test_paged_attention_kernel_matches_plain(cuda, D, dtype, case):
    """K1 (split-K: partials per span of pages, then the merge) against
    the plain version on the same inputs. "edges": lengths at every edge
    of K1's splits (1, a page, a split, a split + 1, two splits, the full
    table) and a scratch page full of junk the kernel must never read;
    "long": one sequence of 2040 tokens over 255 pages. fp32 atol 2e-5
    (summation order); bf16 against the plain version in fp32 on the same
    values, rounded to bf16, atol 1e-2 (one rounding of the output). D 80
    and 96 give a row a number of 16-byte chunks that is not a power of
    two (lanes past it idle); fp32 D 256 gives a lane two chunks."""
    g = torch.Generator(device=cuda).manual_seed(D)
    H, P = 3, 8
    span = paged_ops._pages_per_split(P) * P
    if case == "edges":
        lens = [1, P, span, span + 1, 2 * span, 6 * P]
        N, PP = 50, 6
    else:
        lens = [2040]
        N, PP = 260, 256
    B = len(lens)
    kp = torch.randn(H, N, P, D, generator=g, device=cuda).to(dtype)
    vp = torch.randn(H, N, P, D, generator=g, device=cuda).to(dtype)
    kp[:, 0] = 1e4   # the scratch page
    vp[:, 0] = -1e4
    pt = torch.zeros(B, PP, dtype=torch.int32, device=cuda)
    for b, n in enumerate(lens):
        used = -(-n // P)
        pt[b, :used] = (torch.randperm(N - 1, generator=g, device=cuda)[
            :used] + 1).int()
    pos = torch.tensor(lens, dtype=torch.int32, device=cuda) - 1
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
    n0 = paged_ops.paged_attention.launches
    out = paged_ops.paged_attention(q, kp, vp, pt, pos, 0.125)
    ref = paged_ops.paged_attention_plain(q.float(), kp.float(), vp.float(),
                                          pt, pos, 0.125).to(dtype)
    assert paged_ops.paged_attention.launches == n0 + 1
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=2e-5 if dtype == torch.float32 else 1e-2,
                               rtol=0)


@pytest.mark.parametrize("D", [100, 264])
def test_paged_attention_kernel_raises_on_unserved_head_dim(cuda, D):
    """ROADMAP C7's limit: on a CUDA tensor a head dim outside D % 8 == 0,
    D <= 256 raises; it is never served by the plain version."""
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    q = torch.zeros(1, 2, D, device=cuda)
    kp = torch.zeros(2, 3, 4, D, device=cuda)
    pt = torch.ones(1, 2, dtype=torch.int32, device=cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    n0 = paged_ops.paged_attention.launches
    with pytest.raises(InvalidArgumentError, match=str(D)):
        paged_ops.paged_attention(q, kp, kp, pt, pos, 0.125)
    assert paged_ops.paged_attention.launches == n0


# max |kernel - plain| <= TOL x max(1, max |plain|) in the 16-bit types: one
# rounding of P (K2), of dS / Pd (K3, K4) and of the output; float16 keeps
# 10 mantissa bits to bfloat16's 7
TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3}


def _assert_within(got, want, tol):
    """max |got - want| <= tol x max(1, max |want|), in float32."""
    err = (got.float() - want.float()).abs().max().item()
    top = max(1.0, want.float().abs().max().item())
    assert err <= tol * top, f"max abs err {err:.3e} > {tol} x {top:.3e}"


@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_kernel_matches_plain(cuda, causal, D, dtype, p):
    """K2 against `_flash_fwd_reference` on the same inputs and seed, so
    the keep mask is replayed bit for bit: fp32 atol 1e-4 (the products
    are 3xTF32, fp32-accurate, summed in another order); bf16 1e-2 and
    fp16 2e-3 x max(1, max |ref|) (K2 rounds P to q's type before P V,
    and the output). The bias masks a tail of the second sequence."""
    g = torch.Generator(device=cuda).manual_seed(D + causal)
    q, k, v = (torch.randn(2, 3, 192, D, generator=g, device=cuda)
               .to(dtype) for _ in range(3))
    bias = torch.zeros(2, 192, device=cuda)
    bias[1, 150:] = -1e30
    n0 = flash_ops.flash_attention_fwd.launches
    out, lse = flash_ops.flash_attention_fwd(q, k, v, bias, causal, 0.2, p,
                                             17)
    assert flash_ops.flash_attention_fwd.launches == n0 + 1
    ref, ref_lse = flash_ops._flash_fwd_reference(q, k, v, bias, causal, 0.2,
                                                  p, 17)
    assert out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        _assert_within(out, ref, TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("causal,Sq,Sk", [(False, 192, 192),
                                          (True, 192, 192),
                                          (False, 128, 320)])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_backward_kernels_match_plain(cuda, p, causal, Sq, Sk, D,
                                            dtype):
    """K2 with dropout, K3 and K4 against their plain versions on the same
    inputs and seed: fp32 atol 1e-4, bf16 1e-2 and fp16 2e-3 x max(1, max
    |ref|) (one rounding of dS / Pd and of the output). S 192 is an odd
    number of 64-row tiles, so the double buffers end on either one;
    Sq != Sk holds the non-causal key and query ranges apart."""
    g = torch.Generator(device=cuda).manual_seed(D + causal + Sk)
    q, do = (torch.randn(2, 3, Sq, D, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, 3, Sk, D, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    bias = torch.zeros(2, Sk, device=cuda)
    bias[1, 150:] = -1e30
    out, lse = flash_ops.flash_attention_fwd(q, k, v, bias, causal, 0.2, p,
                                             11)
    ref, ref_lse = flash_ops._flash_fwd_reference(q, k, v, bias, causal,
                                                  0.2, p, 11)
    tol = TOL.get(dtype, 1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        _assert_within(out, ref, tol)
    delta = flash_ops._delta(ref, do)
    args = (q, k, v, bias, do, ref_lse, delta, causal, 0.2, p, 11)
    n3 = flash_ops.flash_attention_dq.launches
    n4 = flash_ops.flash_attention_dkv.launches
    got = [flash_ops.flash_attention_dq(*args),
           *flash_ops.flash_attention_dkv(*args)]
    want = [flash_ops._dq_reference(*args), *flash_ops._dkv_reference(*args)]
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
        else:
            _assert_within(a, b, tol)
    assert flash_ops.flash_attention_dq.launches == n3 + 1
    assert flash_ops.flash_attention_dkv.launches == n4 + 1


def test_c4_gradients_flow_through_the_flash_kernel(cuda):
    """ROADMAP C4: through F.scaled_dot_product_attention on the CUDA
    flash path with p = 0, q/k/v get gradients, and they match autograd
    through `_sdpa_ref` (atol 1e-4)."""
    from paddle_tpu_torch.nn.functional import attention
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do = (torch.randn(2, 4, 512, 64, generator=g, device=cuda)
                   for _ in range(4))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = flash_ops.flash_attention_fwd.launches
    out = attention.scaled_dot_product_attention(*ins, is_causal=True,
                                                 training=True)
    assert flash_ops.flash_attention_fwd.launches == n0 + 1
    out.backward(do)
    dense = [t.clone().requires_grad_() for t in (q, k, v)]
    attention._sdpa_ref(*dense, None, 0.125, True).backward(do)
    for a, b in zip(ins, dense):
        assert a.grad is not None
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=0)


def _packed_ids(B, S, g, device, layout="packed"):
    """Non-decreasing segment ids [B, S]. "packed": random boundaries, off
    the tile grid, one row a single segment. "boundaries": segments of
    1-15 tokens, so a boundary falls inside most 16x8 sub-tiles. "one":
    one segment across every row, so K6 and K7 skip no sub-tile but those
    above the diagonal. "aligned": segments of 64, 128 or 192 tokens, so
    every edge falls on a 16-row and a 64-key boundary and K5 takes its
    mask-free path on most tiles. "midwarp": every edge 8 rows into a
    warp's 16."""
    seg = torch.zeros(B, S, dtype=torch.int32)
    if layout == "packed":
        for b in range(1, B):
            cuts = torch.randint(1, S, (3 * b,), generator=g)
            for c in cuts.tolist():
                seg[b, c:] += 1
    elif layout == "boundaries":
        for b in range(B):
            lens = torch.randint(1, 16, (S,), generator=g)
            seg[b] = torch.repeat_interleave(
                torch.arange(S, dtype=torch.int32), lens)[:S]
    elif layout in ("aligned", "midwarp"):
        unit, first = (64, 0) if layout == "aligned" else (16, 8)
        for b in range(B):
            lens = unit * torch.randint(1, 4, (S,), generator=g)
            edges = (first + torch.cumsum(lens, 0)).tolist()
            for c in [first] * (first > 0) + edges:
                if c < S:
                    seg[b, c:] += 1
    return seg.to(device)


@pytest.mark.parametrize("layout", ["packed", "boundaries", "one",
                                    "aligned", "midwarp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_splash_kernels_match_plain(cuda, p, causal, D, dtype, layout):
    """K5, K6 and K7 against their plain versions on the same inputs,
    segment ids and seed, one launch each. fp32 atol 1e-4 (the kernels
    multiply as 3xTF32, fp32-accurate, in another order), and on the
    "aligned" and "midwarp" ids 1e-4 x max(1, max |ref|) as chip_smoke's
    phase 3 holds them (their gradients reach ~8 at D 128); bf16 1e-2 x
    max(1, max |ref|) (one bf16 rounding of P in K5 and of dS and Pd in
    K6 and K7, as the TPU kernels cast them, and of the output). The
    backward pair is fed the plain forward's O and LSE. On "aligned" ids
    most of K5's (warp band, key tile) pairs take its mask-free path."""
    from paddle_tpu_torch.ops import splash_ops
    g = torch.Generator().manual_seed(D + causal)
    q, k, v, do = (torch.randn(3, 2, 256, D, generator=g).to(cuda, dtype)
                   for _ in range(4))
    seg = _packed_ids(3, 256, g, cuda, layout)
    if layout == "aligned" and not causal:
        vis, uni = splash_ops._uniform_tiles(seg, seg, causal,
                                             32 if D == 128 else 64)
        assert int(uni.sum()) > int(vis.sum()) // 2
    n = [w.launches for w in (splash_ops.splash_attention_fwd,
                              splash_ops.splash_attention_dq,
                              splash_ops.splash_attention_dkv)]
    out, lse = splash_ops.splash_attention_fwd(q, k, v, seg, seg, causal,
                                               0.2, p, 11)
    ref, ref_lse = splash_ops._splash_fwd_reference(q, k, v, seg, seg,
                                                    causal, 0.2, p, 11)
    def close(a, b):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype == torch.float32 and layout in ("packed", "boundaries",
                                                 "one"):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
        else:
            _assert_within(a, b, 1e-4 if dtype == torch.float32 else 1e-2)
    close(out, ref)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    delta = flash_ops._delta(ref, do)
    args = (q, k, v, seg, seg, do, ref_lse, delta, causal, 0.2, p, 11)
    got = [splash_ops.splash_attention_dq(*args),
           *splash_ops.splash_attention_dkv(*args)]
    want = [splash_ops._splash_dq_reference(*args),
            *splash_ops._splash_dkv_reference(*args)]
    for a, b in zip(got, want):
        close(a, b)
    assert [w.launches for w in (splash_ops.splash_attention_fwd,
                                 splash_ops.splash_attention_dq,
                                 splash_ops.splash_attention_dkv)] == \
        [x + 1 for x in n]


def test_float16_reaches_flash_but_splash_raises(cuda):
    """ROADMAP C8. float16 passes flash_supported's type check and K2
    takes it; K5-K7 have no float16 build, so a float16 splash call on
    the card raises InvalidArgumentError (never a quiet plain path) and
    launches nothing."""
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.ops import splash_ops
    q = torch.randn(1, 2, 128, 64, device=cuda).half()
    seg = torch.zeros(1, 128, dtype=torch.int32, device=cuda)
    assert flash_ops.flash_supported(tuple(q.shape), dtype=q.dtype,
                                     min_seq=128)
    n2 = flash_ops.flash_attention_fwd.launches_by_dtype["float16"]
    out = flash_ops.flash_attention(q, q, q, causal=True)
    assert out.dtype == torch.float16
    assert flash_ops.flash_attention_fwd.launches_by_dtype["float16"] == \
        n2 + 1
    assert splash_ops.splash_supported(tuple(q.shape), min_seq=128)
    n5 = splash_ops.splash_attention_fwd.launches
    with pytest.raises(InvalidArgumentError, match="float16"):
        splash_ops.splash_attention(q, q, q, seg, seg, causal=True)
    assert splash_ops.splash_attention_fwd.launches == n5


def test_splash_absent_segment_rows_are_zero(cuda):
    """A query segment absent from kv: its output rows and dQ rows are
    exactly 0 on the card, and SplashAttention's gradients match autograd
    through the plain forward (atol 1e-4)."""
    from paddle_tpu_torch.ops import splash_ops
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(2, 2, 256, 64, generator=g).to(cuda)
                   for _ in range(4))
    q_seg = torch.zeros(2, 256, dtype=torch.int32)
    q_seg[:, 90:] = 1
    q_seg[:, 170:] = 2
    kv_seg = q_seg.clone()
    kv_seg[0][kv_seg[0] == 1] = 0
    q_seg, kv_seg = q_seg.to(cuda), kv_seg.to(cuda)
    out, lse = splash_ops.splash_attention_fwd(q, k, v, q_seg, kv_seg, False,
                                               0.125)
    assert (out[0, :, 90:170] == 0).all()
    delta = flash_ops._delta(out, do)
    dq = splash_ops.splash_attention_dq(q, k, v, q_seg, kv_seg, do, lse,
                                        delta, False, 0.125)
    assert (dq[0, :, 90:170] == 0).all()
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(splash_ops.splash_attention(
        *ins, q_seg, kv_seg, causal=False, scale=0.125), ins, do)
    dense = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(splash_ops._splash_fwd_reference(
        *dense, q_seg, kv_seg, False, 0.125)[0], dense, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
