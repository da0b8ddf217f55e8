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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [32, 64, 128, 80, 96, 256, 36, 100, 264,
                               512])
def test_paged_attention_kernel_matches_plain(cuda, D, dtype, case):
    """K1 (split-K: partials per span of pages, then the merge) against
    the plain version on the same inputs. "edges": lengths at every edge
    of K1's splits (1, a page, a split, a split + 1, two splits, the full
    table) and a scratch page full of junk the kernel must never read;
    "long": one sequence of 2040 tokens over 255 pages. fp32 atol 2e-5
    (summation order); bf16 against the plain version in fp32 on the same
    values, rounded to bf16, atol 1e-2 (one rounding of the output); fp16
    (ROADMAP C10) the same way, atol 2e-3 (one rounding to 10 mantissa
    bits of an output below 4 in magnitude, ulp 2^-9, with fp32 sums). D 80
    and 96 give a row a number of 16-byte chunks that is not a power of
    two (lanes past it idle); fp32 D 256 gives a lane two chunks. D 36,
    100, 264 and 512 run at the padded widths 64, 128, 512 and 512, their
    rows loaded one value at a time and masked at D."""
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
                               atol={torch.float32: 2e-5,
                                     torch.bfloat16: 1e-2,
                                     torch.float16: 2e-3}[dtype], rtol=0)


@pytest.mark.parametrize("D", [520, 1024])
def test_paged_attention_kernel_raises_on_unserved_head_dim(cuda, D):
    """ROADMAP B: on a CUDA tensor a head dim above 512 raises, from
    `paged_attention` and from K1's own check alike, before any launch;
    it is never served by the plain version."""
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    q = torch.zeros(1, 2, D, device=cuda)
    kp = torch.zeros(2, 3, 4, D, device=cuda)
    pt = torch.ones(1, 2, dtype=torch.int32, device=cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    n0 = paged_ops.paged_attention.launches
    with pytest.raises(InvalidArgumentError, match=str(D)):
        paged_ops.paged_attention(q, kp, kp, pt, pos, 0.125)
    with pytest.raises(InvalidArgumentError, match=str(D)):
        paged_ops._launch_paged_kernel(q, kp, kp, pt, pos, 0.125)
    assert paged_ops.paged_attention.launches == n0


def test_head_dim_36_gpt_serves_on_cuda(cuda):
    """A GPT with head dim 36 (hidden 144, 4 heads) serves on the card
    through K1 at its padded width: one launch a layer a step, none of
    them the plain version (STAT_paged_attn_reference stays), token for
    token what the port's engine gives on the CPU (which
    `tests/test_torch_generation_engine.py::
    test_head_dim_36_gpt_identical_to_jax_engine` holds to the JAX
    engine) and what the model's dense `generate()` gives on the card."""
    import numpy as np

    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine
    cfg = GPTConfig.tiny(hidden_size=144, intermediate_size=288,
                         dropout=0.0)
    cpu_model = GPTForCausalLM(cfg, device="cpu").eval()
    gpu_model = GPTForCausalLM(cfg, device="cuda").eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    prompts = [np.arange(1, 6 + 3 * i) % 512 for i in range(3)]
    kw = dict(max_slots=2, page_size=4, num_pages=32,
              prefill_buckets=(16, 32), max_new_tokens=6)
    with GenerationEngine(cpu_model, device="cpu", **kw) as e:
        want = [e.generate(p) for p in prompts]
    n0 = paged_ops.paged_attention.launches
    with GenerationEngine(gpu_model, device="cuda", **kw) as e:
        r0 = monitor.stat_get("STAT_paged_attn_reference")
        n1 = paged_ops.paged_attention.launches
        got = [e.generate(p) for p in prompts]
        steps = e.stats()["steps"]
        assert monitor.stat_get("STAT_paged_attn_reference") == r0
        assert paged_ops.paged_attention.launches - n1 == \
            steps * cfg.num_layers
    assert n1 > n0    # the warmup's decode step launched K1 too
    for w, g_, p in zip(want, got, prompts):
        np.testing.assert_array_equal(w, g_)
        np.testing.assert_array_equal(
            g_, gpu_model.generate(torch.as_tensor(p[None]),
                                   max_new_tokens=6)[0].cpu().numpy())


# max |kernel - plain| <= TOL x max(1, max |plain|) in the 16-bit types: one
# rounding of P (K2), of dS / Pd (K3, K4) and of the output; float16 keeps
# 10 mantissa bits to bfloat16's 7
TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3}


def _assert_within(got, want, tol):
    """max |got - want| <= tol x max(1, max |want|), in float32."""
    err = (got.float() - want.float()).abs().max().item()
    top = max(1.0, want.float().abs().max().item())
    assert err <= tol * top, f"max abs err {err:.3e} > {tol} x {top:.3e}"


# head dims: the three built before ROADMAP C11 (scale 0.2), and since
# C11 D 80, 96 and 256 (scale 1/sqrt(D)), which run at padded widths
HEAD_DIMS = [32, 64, 128, 80, 96, 256]


def _scale(D):
    return 0.2 if D in (32, 64, 128) else D ** -0.5


@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", HEAD_DIMS)
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
    sc = _scale(D)
    n0 = flash_ops.flash_attention_fwd.launches
    out, lse = flash_ops.flash_attention_fwd(q, k, v, bias, causal, sc, p,
                                             17)
    assert flash_ops.flash_attention_fwd.launches == n0 + 1
    ref, ref_lse = flash_ops._flash_fwd_reference(q, k, v, bias, causal, sc,
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
@pytest.mark.parametrize("D", HEAD_DIMS)
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
    sc = _scale(D)
    out, lse = flash_ops.flash_attention_fwd(q, k, v, bias, causal, sc, p,
                                             11)
    ref, ref_lse = flash_ops._flash_fwd_reference(q, k, v, bias, causal,
                                                  sc, p, 11)
    tol = TOL.get(dtype, 1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        _assert_within(out, ref, tol)
    delta = flash_ops._delta(ref, do)
    args = (q, k, v, bias, do, ref_lse, delta, causal, sc, p, 11)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_splash_kernels_match_plain(cuda, p, causal, D, dtype, layout):
    """K5, K6 and K7 against their plain versions on the same inputs,
    segment ids and seed, one launch each. fp32 atol 1e-4 (the kernels
    multiply as 3xTF32, fp32-accurate, in another order), and on the
    "aligned" and "midwarp" ids 1e-4 x max(1, max |ref|) as chip_smoke's
    phase 3 holds them (their gradients reach ~8 at D 128); bf16 1e-2 x
    max(1, max |ref|) (one bf16 rounding of P in K5 and of dS and Pd in
    K6 and K7, as the TPU kernels cast them, and of the output); fp16
    2e-3 x max(1, max |ref|), as the flash kernels' fp16 rows. The
    backward pair is fed the plain forward's O and LSE. On "aligned" ids
    most of K5's (warp band, key tile) pairs take its mask-free path."""
    from paddle_tpu_torch.ops import splash_ops
    g = torch.Generator().manual_seed(D + causal)
    q, k, v, do = (torch.randn(3, 2, 256, D, generator=g).to(cuda, dtype)
                   for _ in range(4))
    seg = _packed_ids(3, 256, g, cuda, layout)
    if layout == "aligned" and not causal:
        vis, uni = splash_ops._uniform_tiles(
            seg, seg, causal, splash_ops._k5_key_tile(D, dtype))
        assert int(uni.sum()) > int(vis.sum()) // 2
    n = [w.launches for w in (splash_ops.splash_attention_fwd,
                              splash_ops.splash_attention_dq,
                              splash_ops.splash_attention_dkv)]
    sc = _scale(D)
    out, lse = splash_ops.splash_attention_fwd(q, k, v, seg, seg, causal,
                                               sc, p, 11)
    ref, ref_lse = splash_ops._splash_fwd_reference(q, k, v, seg, seg,
                                                    causal, sc, p, 11)
    def close(a, b):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype == torch.float32 and layout in ("packed", "boundaries",
                                                 "one"):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
        else:
            _assert_within(a, b, {torch.float32: 1e-4, torch.bfloat16: 1e-2,
                                  torch.float16: 2e-3}[dtype])
    close(out, ref)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    delta = flash_ops._delta(ref, do)
    args = (q, k, v, seg, seg, do, ref_lse, delta, causal, sc, p, 11)
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


def test_float16_reaches_flash_and_splash(cuda):
    """ROADMAP C8, repaired. float16 passes flash_supported's and
    splash_supported's checks, and K2 and K5-K7 take it: a float16 splash
    call on the card launches K5 forward and K6 + K7 backward in float16
    (counted by type) and agrees with the dense float32 reference within
    2e-3 x max(1, max |ref|)."""
    from paddle_tpu_torch.ops import splash_ops
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(1, 2, 128, 64, generator=g).to(cuda).half()
                   for _ in range(4))
    seg = torch.zeros(1, 128, dtype=torch.int32)
    seg[:, 50:] = 1
    seg = seg.to(cuda)
    assert flash_ops.flash_supported(tuple(q.shape), dtype=q.dtype,
                                     min_seq=128)
    n2 = flash_ops.flash_attention_fwd.launches_by_dtype["float16"]
    out = flash_ops.flash_attention(q, q, q, causal=True)
    assert out.dtype == torch.float16
    assert flash_ops.flash_attention_fwd.launches_by_dtype["float16"] == \
        n2 + 1
    assert splash_ops.splash_supported(tuple(q.shape), min_seq=128)
    counts = {w: w.launches_by_dtype["float16"]
              for w in (splash_ops.splash_attention_fwd,
                        splash_ops.splash_attention_dq,
                        splash_ops.splash_attention_dkv)}
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = splash_ops.splash_attention(qq, kk, vv, seg, seg, causal=True)
    out.backward(do)
    assert out.dtype == qq.grad.dtype == torch.float16
    for w, n in counts.items():
        assert w.launches_by_dtype["float16"] == n + 1, w.__name__
    ref = splash_ops.sdpa_segment_reference(q.float(), k.float(), v.float(),
                                            seg, seg, True, 0.125)
    lim = 2e-3 * max(1.0, ref.abs().max().item())
    assert (out.float() - ref).abs().max().item() <= lim


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


# one head dim of every padded width each type runs (csrc/flash_mma.cuh
# "Head dims"): 8 and 24 -> 32, 40 -> 64, 72 -> 96 (fp32) or 128, 104 ->
# 128, 136 and 184 -> 192, 200 and 248 -> 256; 192 and 256 fill theirs
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [8, 24, 40, 72, 104, 136, 184, 192, 200,
                               248])
def test_every_padded_width_matches_plain(cuda, D, dtype):
    """ROADMAP C11: K2-K7 at a head dim of every padded width, causal, p
    0.2, against their plain versions (tolerances as above: fp32 atol 1e-4
    x max(1, max |ref|), bf16 1e-2, fp16 2e-3): the zero-filled columns
    past D change no score and are never stored, and the column halves of
    K4 and K7 above width 128 meet. One launch of each kernel, counted by
    type; no call falls to a plain version."""
    from paddle_tpu_torch.ops import splash_ops
    g = torch.Generator().manual_seed(D)
    q, k, v, do = (torch.randn(2, 2, 192, D, generator=g).to(cuda, dtype)
                   for _ in range(4))
    seg = _packed_ids(2, 192, g, cuda, "packed")
    sc = D ** -0.5
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2,
           torch.float16: 2e-3}[dtype]
    name = str(dtype).replace("torch.", "")
    wrappers = (flash_ops.flash_attention_fwd, flash_ops.flash_attention_dq,
                flash_ops.flash_attention_dkv,
                splash_ops.splash_attention_fwd,
                splash_ops.splash_attention_dq,
                splash_ops.splash_attention_dkv)
    n = [w.launches_by_dtype[name] for w in wrappers]
    out, lse = flash_ops.flash_attention_fwd(q, k, v, None, True, sc, 0.2, 5)
    ref, ref_lse = flash_ops._flash_fwd_reference(q, k, v, None, True, sc,
                                                  0.2, 5)
    _assert_within(out, ref, tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    delta = flash_ops._delta(ref, do)
    args = (q, k, v, None, do, ref_lse, delta, True, sc, 0.2, 5)
    for a, b in zip([flash_ops.flash_attention_dq(*args),
                     *flash_ops.flash_attention_dkv(*args)],
                    [flash_ops._dq_reference(*args),
                     *flash_ops._dkv_reference(*args)]):
        assert a.dtype == dtype and a.shape == b.shape
        _assert_within(a, b, tol)
    out, lse = splash_ops.splash_attention_fwd(q, k, v, seg, seg, True, sc,
                                               0.2, 5)
    ref, ref_lse = splash_ops._splash_fwd_reference(q, k, v, seg, seg, True,
                                                    sc, 0.2, 5)
    _assert_within(out, ref, tol)
    delta = flash_ops._delta(ref, do)
    args = (q, k, v, seg, seg, do, ref_lse, delta, True, sc, 0.2, 5)
    for a, b in zip([splash_ops.splash_attention_dq(*args),
                     *splash_ops.splash_attention_dkv(*args)],
                    [splash_ops._splash_dq_reference(*args),
                     *splash_ops._splash_dkv_reference(*args)]):
        assert a.dtype == dtype and a.shape == b.shape
        _assert_within(a, b, tol)
    assert [w.launches_by_dtype[name] for w in wrappers] == \
        [x + 1 for x in n]


@pytest.mark.parametrize("D", [264, 512])
def test_wide_head_dims_fall_back_counted(cuda, D):
    """ROADMAP C11's limit: a head dim of (256, 512], which the JAX
    package's kernels take, is refused by both gates (counted in
    STAT_attention_wide_head_fallback) and served by the plain path, so
    F.scaled_dot_product_attention on the card launches no kernel; the
    kernels' own check raises on it."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.nn.functional import attention
    q = torch.randn(1, 2, 512, D, device=cuda)
    n0 = monitor.stat_get("STAT_attention_wide_head_fallback")
    k0 = flash_ops.flash_attention_fwd.launches
    out = attention.scaled_dot_product_attention(q, q, q, is_causal=True,
                                                 training=False)
    assert out.shape == q.shape
    assert flash_ops.flash_attention_fwd.launches == k0
    assert monitor.stat_get("STAT_attention_wide_head_fallback") == n0 + 1
    with pytest.raises(InvalidArgumentError):
        flash_ops.flash_attention_fwd(q, q, q, None, True, 0.1)


def _ernie_bias(B, S, seed, device):
    """ERNIE's key-padding bias: (1 - m) * -1e4 over seeded row lengths
    S/4..S (the first row unpadded), float32 [B, S]."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(S // 4, S + 1, (B,), generator=g)
    lens[0] = S
    m = (torch.arange(S)[None] < lens[:, None]).float()
    return ((1.0 - m) * -1e4).to(device)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,D", [(4, 32), (12, 64)])
def test_flash_kernels_on_ernie_key_bias(cuda, H, D, dtype, p):
    """K2, K3 and K4 non-causal on ERNIE's key-padding bias at S 512 (the
    flash minimum), head dims of ERNIE-tiny (D 32) and ERNIE-base (D 64),
    against their plain versions on the same inputs and seed: fp32 atol
    1e-4, bf16 1e-2 x max(1, max |ref|)."""
    B, S = 2, 512
    g = torch.Generator(device=cuda).manual_seed(D + int(p * 10))
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device=cuda)
                   .to(dtype) for _ in range(4))
    bias = _ernie_bias(B, S, D, cuda)
    sc = D ** -0.5
    n = [w.launches for w in (flash_ops.flash_attention_fwd,
                              flash_ops.flash_attention_dq,
                              flash_ops.flash_attention_dkv)]
    out, lse = flash_ops.flash_attention_fwd(q, k, v, bias, False, sc, p, 5)
    ref, ref_lse = flash_ops._flash_fwd_reference(q, k, v, bias, False, sc,
                                                  p, 5)
    delta = flash_ops._delta(ref, do)
    args = (q, k, v, bias, do, ref_lse, delta, False, sc, p, 5)
    got = [out, flash_ops.flash_attention_dq(*args),
           *flash_ops.flash_attention_dkv(*args)]
    want = [ref, flash_ops._dq_reference(*args),
            *flash_ops._dkv_reference(*args)]
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a.float()).all()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
        else:
            _assert_within(a, b, TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    assert [w.launches for w in (flash_ops.flash_attention_fwd,
                                 flash_ops.flash_attention_dq,
                                 flash_ops.flash_attention_dkv)] == \
        [c + 1 for c in n]


def test_ernie_tiny_step_through_the_kernels(cuda):
    """An ERNIE-tiny (D 32) classifier at [2, 512] with a padding mask,
    dropout 0: loss and every gradient through K2-K4 (one launch each a
    layer) against FLAGS_use_flash_attention=False; loss rtol 1e-5, each
    gradient within 1e-3 x its max + 1e-6 x the model's max."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import (ErnieConfig,
                                         ErnieForSequenceClassification)
    # tiny() takes no overrides (as the JAX package's): set them
    cfg = ErnieConfig.tiny()
    cfg.max_position_embeddings = 512
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    net = ErnieForSequenceClassification(cfg, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.randint(1, cfg.vocab_size, (2, 512), generator=g,
                        device=cuda)
    mask = (_ernie_bias(2, 512, 3, cuda) == 0).float()
    labels = torch.tensor([0, 1], device=cuda)

    def step():
        net.zero_grad()
        n0 = flash_ops.flash_attention_dkv.launches
        loss = torch.nn.functional.cross_entropy(
            net(ids, None, None, mask), labels)
        loss.backward()
        return (loss.item(), {n: p.grad.clone()
                              for n, p in net.named_parameters()},
                flash_ops.flash_attention_dkv.launches - n0)

    lf, gf, nf = step()
    set_flags({"FLAGS_use_flash_attention": False})
    try:
        lp, gp, np_ = step()
    finally:
        set_flags({"FLAGS_use_flash_attention": True})
    assert (nf, np_) == (cfg.num_hidden_layers, 0)
    assert abs(lf - lp) <= 1e-5 * abs(lp)
    floor = 1e-6 * max(x.abs().max().item() for x in gp.values())
    for n in gp:
        err = (gf[n] - gp[n]).abs().max().item()
        assert err <= 1e-3 * gp[n].abs().max().item() + floor, (n, err)


def test_resnet50_builds_on_the_card_by_default(cuda):
    """No `device=`: every parameter and buffer of resnet50 on the card."""
    from paddle_tpu_torch.vision.models import resnet50
    net = resnet50()
    assert all(t.is_cuda for t in net.state_dict().values())
    assert sum(p.numel() for p in net.parameters()) == 25_557_032


def test_resnet18_o1_step_runs_convs_in_bf16(cuda):
    """One hapi train_batch of resnet18 under amp_configs="O1" on the
    card: every Conv2D emits bfloat16 and every BatchNorm float32 (forward
    hooks); the loss is finite and the BatchNorm buffers moved."""
    from paddle_tpu_torch import hapi, nn, optimizer
    from paddle_tpu_torch.vision.models import resnet18
    net = resnet18(num_classes=10, device=cuda)
    seen = {"conv": set(), "bn": set()}
    for m in net.modules():
        kind = ("conv" if isinstance(m, nn.Conv2D) else
                "bn" if isinstance(m, nn.BatchNorm2D) else None)
        if kind:
            m.register_forward_hook(
                lambda mod, i, o, k=kind: seen[k].add(o.dtype))
    model = hapi.Model(net).prepare(optimizer.Momentum(0.1),
                                    nn.CrossEntropyLoss(), amp_configs="O1")
    before = net.bn1._mean.clone()
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(4, 3, 64, 64, generator=g, device=cuda)
    y = torch.randint(0, 10, (4,), generator=g, device=cuda)
    loss, _ = model.train_batch([x], [y])
    assert torch.isfinite(loss[0]).item()
    assert seen == {"conv": {torch.bfloat16}, "bn": {torch.float32}}
    assert not torch.equal(before, net.bn1._mean)


def test_flash_op_on_cuda_launches_k2(cuda):
    """The registered op `paddle_tpu_torch::flash_fwd` on CUDA tensors
    launches K2 once a call (not the plain version) and matches the plain
    version at ERNIE-base's inference shape [2, 12, 512, 64] on a key
    bias: fp32 within 1e-4, bf16 within 1e-2 (phase 3's limits)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    bias = _ernie_bias(2, 512, 7, cuda)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        q, k, v = (torch.randn(2, 12, 512, 64, generator=g, device=cuda)
                   .to(dtype) for _ in range(3))
        n0 = flash_ops.flash_attention_fwd.launches
        out, lse = torch.ops.paddle_tpu_torch.flash_fwd(
            q, k, v, bias, False, 0.125, 0.0, 0)
        assert flash_ops.flash_attention_fwd.launches == n0 + 1
        ref, ref_lse = flash_ops._flash_fwd_reference(q, k, v, bias, False,
                                                      0.125)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


def test_cpu_saved_artifact_launches_k2_on_the_card(cuda, tmp_path):
    """An ERNIE-tiny classifier saved on the CPU (FLAGS_flash_attention_
    min_seq 128, seq 128, symbolic batch) and loaded through
    `inference.Config()` (the card by default) runs on the card, launches
    K2 once a layer a run at batch 1 and 3, and gives the eager model's
    logits on the card within 1e-4 x max(1, max |ref|); `jit.load` with
    no device does the same on host (numpy) inputs."""
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.models import (ErnieConfig,
                                         ErnieForSequenceClassification)
    from paddle_tpu_torch.static import InputSpec

    class Cls(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, ids, mask):
            return self.net(ids, attention_mask=mask)

    old = get_flags(["FLAGS_flash_attention_min_seq"])
    set_flags({"FLAGS_flash_attention_min_seq": 128})
    try:
        cfg = ErnieConfig.tiny()
        cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
        net = Cls(ErnieForSequenceClassification(cfg, device="cpu")).eval()
        spec = [InputSpec([None, 128], "int64")] * 2
        jit.save(net, str(tmp_path / "ernie"), input_spec=spec)
        pred = inference.create_predictor(
            inference.Config(str(tmp_path / "ernie")))
        assert pred.device.type == "cuda"
        layer = jit.load(str(tmp_path / "ernie"))
        assert layer.device.type == "cuda"
        net = net.to(cuda)
        g = torch.Generator().manual_seed(0)
        for rows in (1, 3):
            ids = torch.randint(1, cfg.vocab_size, (rows, 128), generator=g)
            mask = torch.ones(rows, 128, dtype=torch.int64)
            mask[0, 64:] = 0
            n0 = flash_ops.flash_attention_fwd.launches
            got = pred.run([ids.numpy(), mask.numpy()])[0]
            assert flash_ops.flash_attention_fwd.launches - n0 == \
                cfg.num_hidden_layers
            with torch.no_grad():
                want = net(ids.to(cuda), mask.to(cuda)).cpu().numpy()
            assert abs(got - want).max() <= 1e-4 * max(1.0,
                                                      abs(want).max())
            n0 = flash_ops.flash_attention_fwd.launches
            out = layer(ids.numpy(), mask.numpy())
            assert out.device.type == "cuda"
            assert flash_ops.flash_attention_fwd.launches - n0 == \
                cfg.num_hidden_layers
            got = out.float().cpu().numpy()
            assert abs(got - want).max() <= 1e-4 * max(1.0,
                                                      abs(want).max())
    finally:
        set_flags(old)


def test_flash_op_refusal_raises_on_cuda(cuda):
    """A CUDA call K2 does not take (sequence 100, not a multiple of 64)
    raises InvalidArgumentError through the op; it never falls back to the
    plain version and launches nothing."""
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    q = torch.randn(1, 2, 100, 64, device=cuda)
    n0 = flash_ops.flash_attention_fwd.launches
    with pytest.raises(InvalidArgumentError, match="multiples of 64"):
        torch.ops.paddle_tpu_torch.flash_fwd(q, q, q, None, False, 0.125,
                                             0.0, 0)
    assert flash_ops.flash_attention_fwd.launches == n0
