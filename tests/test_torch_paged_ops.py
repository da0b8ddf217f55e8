"""paddle_tpu_torch.ops.paged_ops held to paddle_tpu.ops.paged_ops.

Same numpy inputs (seeded) through both packages on the CPU, where the
JAX package takes its dense reference path and the port its plain
version (the CUDA kernel runs only on the card). float32 throughout;
attention outputs agree to atol 1e-5 (the two frameworks sum in other
orders), the index arithmetic and scatters exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_ops as jpo
from paddle_tpu_torch.ops import paged_ops as tpo


def _pools(seed, H=3, N=20, P=4, D=16):
    rng = np.random.RandomState(seed)
    kp = rng.standard_normal((H, N, P, D)).astype(np.float32)
    vp = rng.standard_normal((H, N, P, D)).astype(np.float32)
    return kp, vp


def _tables(seed, B=4, PP=5, N=20, P=4):
    """Random page tables over pages 1..N-1 plus one parked slot (pos 0
    on an all-scratch row), trash-padded past each sequence's pages."""
    rng = np.random.RandomState(seed)
    pt = np.zeros((B, PP), np.int32)
    pos = np.zeros((B,), np.int32)
    for b in range(B - 1):
        length = int(rng.randint(1, PP * P + 1))
        n = -(-length // P)
        pt[b, :n] = rng.choice(np.arange(1, N), size=n, replace=False)
        pos[b] = length - 1
    return pt, pos       # the last row stays parked on the scratch page


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_paged_attention_plain_matches_jax_reference(seed):
    kp, vp = _pools(seed)
    # junk on the scratch page must contribute exactly nothing
    kp[:, 0] = 50.0
    vp[:, 0] = -50.0
    pt, pos = _tables(seed + 100)
    q = np.random.RandomState(seed + 200).standard_normal(
        (pt.shape[0], kp.shape[0], kp.shape[-1])).astype(np.float32)
    scale = 1.0 / np.sqrt(kp.shape[-1])
    ref = np.asarray(jpo.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(pos), scale))
    launches = tpo.paged_attention.launches
    out = tpo.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp), torch.from_numpy(pt),
                              torch.from_numpy(pos), scale).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    assert np.isfinite(out).all()
    assert tpo.paged_attention.launches == launches   # CPU: plain path


def test_cached_attention_scalar_and_vector_pos():
    rng = np.random.RandomState(7)
    q = rng.standard_normal((2, 3, 8)).astype(np.float32)
    kb = rng.standard_normal((2, 3, 10, 8)).astype(np.float32)
    vb = rng.standard_normal((2, 3, 10, 8)).astype(np.float32)
    for pos in (4, np.array([2, 9], np.int32)):
        ref = np.asarray(jpo.cached_attention(
            jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
            jnp.asarray(pos), 0.3))
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        out = tpo.cached_attention(torch.from_numpy(q), torch.from_numpy(kb),
                                   torch.from_numpy(vb), tpos, 0.3).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_paged_gather_matches():
    kp, _ = _pools(5)
    pt, _ = _tables(6)
    ref = np.asarray(jpo.paged_gather(jnp.asarray(kp), jnp.asarray(pt)))
    out = tpo.paged_gather(torch.from_numpy(kp), torch.from_numpy(pt))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", ["1d", "row", "block"])
def test_page_rows_for_positions_equal(shape):
    rng = np.random.RandomState(11)
    P = 4
    if shape == "1d":
        table = rng.randint(1, 30, size=(6,)).astype(np.int32)
        positions = np.arange(24, dtype=np.int32)
    elif shape == "row":
        table = rng.randint(1, 30, size=(3, 6)).astype(np.int32)
        positions = np.array([0, 13, 23], np.int32)
    else:
        table = rng.randint(1, 30, size=(3, 6)).astype(np.int32)
        positions = rng.randint(0, 24, size=(3, 5)).astype(np.int32)
    jp, jo = jpo.page_rows_for_positions(jnp.asarray(table),
                                         jnp.asarray(positions), P)
    tp_, to = tpo.page_rows_for_positions(torch.from_numpy(table),
                                          torch.from_numpy(positions), P)
    np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("layer", [1, None])
def test_paged_write_equal(layer):
    rng = np.random.RandomState(3)
    L, H, N, P, D = 2, 3, 9, 4, 5
    pages = rng.standard_normal((L, H, N, P, D)).astype(np.float32)
    if layer is None:
        ids = np.array([3, 3, 5, 7], np.int32)
        offs = np.array([0, 1, 2, 3], np.int32)
        vals = rng.standard_normal((L, H, 4, D)).astype(np.float32)
    else:
        ids = np.array([2, 6, 8], np.int32)
        offs = np.array([1, 0, 3], np.int32)
        vals = rng.standard_normal((3, H, D)).astype(np.float32)
    ref = np.asarray(jpo.paged_write(jnp.asarray(pages), layer,
                                     jnp.asarray(ids), jnp.asarray(offs),
                                     jnp.asarray(vals)))
    out = tpo.paged_write(torch.from_numpy(pages.copy()), layer,
                          torch.from_numpy(ids), torch.from_numpy(offs),
                          torch.from_numpy(vals))
    np.testing.assert_array_equal(out.numpy(), ref)


def _split_merge(q, kp, vp, pt, pos, scale, pps):
    """Kernel K1's split-K written out in torch: per (b, h), partials
    (max m_s, sum l_s, acc_s) over spans of `pps` whole pages up to the
    sequence's length (no token past it is read), merged by the
    exp(m_s - M) rule."""
    H, _, P, _ = kp.shape
    B, PP = pt.shape
    span = pps * P
    out = torch.empty_like(q)
    for b in range(B):
        n = min(int(pos[b]) + 1, PP * P)
        for h in range(H):
            parts = []
            for t0 in range(0, n, span):
                toks = torch.arange(t0, min(t0 + span, n))
                pages = pt[b, toks // P].long()
                k, v = kp[h, pages, toks % P], vp[h, pages, toks % P]
                s = (k @ q[b, h]) * scale
                p = torch.exp(s - s.max())
                parts.append((s.max(), p.sum(), p @ v))
            assert len(parts) == -(-n // span) <= -(-PP // pps)
            M = max(m for m, _, _ in parts)
            w = [torch.exp(m - M) for m, _, _ in parts]
            out[b, h] = (sum(a * x for (_, _, a), x in zip(parts, w))
                         / sum(l * x for (_, l, _), x in zip(parts, w)))
    return out


@pytest.mark.parametrize("P,PP", [(4, 8), (16, 3)])
def test_split_merge_matches_plain(P, PP):
    """K1's split-merge arithmetic on the CPU, with the wrapper's split
    rule (`_pages_per_split`), against `paged_attention_plain` to 1e-6
    (float32, summation order only): lengths 1, a page, a split, a split
    + 1 and the full table, and a scratch page full of 1e4 that every
    table row points at past its pages, which must not leak in."""
    H, D = 3, 32
    pps = tpo._pages_per_split(P)
    span = pps * P
    lens = [1, P, span, span + 1, PP * P]
    B = len(lens)
    N = B * PP + 1
    rng = np.random.RandomState(P)
    kp = torch.from_numpy(rng.standard_normal((H, N, P, D)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((H, N, P, D)).astype(np.float32))
    kp[:, 0] = 1e4
    vp[:, 0] = 1e4
    pt = torch.zeros(B, PP, dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(N - 1) + 1)
    for b, n in enumerate(lens):
        used = -(-n // P)
        pt[b, :used] = perm[b * PP:b * PP + used].int()
    pos = torch.tensor(lens, dtype=torch.int32) - 1
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    scale = 1.0 / np.sqrt(D)
    got = _split_merge(q, kp, vp, pt, pos, scale, pps)
    want = tpo.paged_attention_plain(q, kp, vp, pt, pos, scale)
    assert torch.isfinite(got).all() and got.abs().max() < 10
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [80, 96, 256, 100, 264, 36, 512, 520])
def test_kernel_argument_check_head_dims(D, dtype):
    """ROADMAP C7: K1's argument check (which builds and launches nothing)
    takes every head dim up to 512 (D % 8 == 0 and D <= 256 at D itself,
    any other, such as D 36, 100 or 264, at a padded width), in the three
    types (float16 since ROADMAP C10), and raises InvalidArgumentError
    naming D and the accepted set above it, such as D 520."""
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    B, H, N, P, PP = 2, 3, 5, 4, 2
    q = torch.zeros(B, H, D, dtype=dtype)
    kp = torch.zeros(H, N, P, D, dtype=dtype)
    pt = torch.ones(B, PP, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    if D <= 512:
        tpo._check_kernel_args(q, kp, kp, pt, pos)
    else:
        with pytest.raises(InvalidArgumentError,
                           match=f"head_dim {D} .*D <= 512"):
            tpo._check_kernel_args(q, kp, kp, pt, pos)
