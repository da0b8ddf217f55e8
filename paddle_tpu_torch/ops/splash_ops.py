"""Splash attention: segment-aware flash attention for packed sequences.

Counterpart of `paddle_tpu/ops/splash_ops.py` (`splash_attention`,
`splash_attention_raw` and the three Pallas kernels behind it).

Sequence packing (`io.PackingCollator`) puts several sequences into one
fixed-shape row, so attention is masked per segment: query i sees key j
iff q_seg[i] == kv_seg[j], and j <= i under causal. Segment ids are
non-decreasing along each row (the packing layout), so the keys a tile
of queries can see form one span; the kernels visit only the key tiles
of that span, and the work follows the real tokens, not the row shape.

- `splash_attention(query, key, value, q_seg, kv_seg, causal, scale,
  dropout_p, generator)`: the framework entry (`splash_ops.py:513`
  there). It checks the ids on the host where that costs no wait, draws
  the dropout seed as `flash_attention` does, and applies
  `SplashAttention`.
- `SplashAttention`: the `torch.autograd.Function` (the JAX package's
  `custom_vjp`). Forward: K5. Backward: `delta = rowsum(dO * O)` in
  torch, then K6 (dQ) and K7 (dK, dV). The tile bounds are computed once,
  on the device, and shared by the three launches.
- The kernel wrappers `splash_attention_fwd` (K5, `csrc/splash_fwd.cu`),
  `splash_attention_dq` (K6, `csrc/splash_bwd_dq.cu`) and
  `splash_attention_dkv` (K7, `csrc/splash_bwd_dkv.cu`): a CUDA `q`
  launches the hand-written kernel or raises; a CPU `q` runs the plain
  version (`_splash_fwd_reference`, `_splash_dq_reference`,
  `_splash_dkv_reference`). Each wrapper's `.launches` counts its kernel
  launches (and `.launches_by_dtype` by operand type), and `STAT_splash_attention_fwd` / `_bwd` count them
  process-wide.
- Types: float32 and bfloat16 (`_DTYPES`). There is no float16 build
  yet: a float16 `q` on the card raises InvalidArgumentError in `_check`,
  never a quiet plain path (ROADMAP C8; the flash kernels take float16).
- A row with no visible key (its segment absent from kv) outputs zeros
  and its LSE is -1e30, as the TPU kernel's `l_safe` gives.
- Dropout uses `flash_ops._keep_mask`, the flash kernels' coordinate
  hash, so K5-K7 and the plain versions replay one mask.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from .. import amp
from ..framework import monitor
from ..framework.errors import InvalidArgumentError
from ..framework.flags import flag
from .flash_ops import (_BLOCK_MIN, _HEAD_DIMS, _KERNEL_TILE, _NEG_INF,
                        _check, _count, _delta, _dropout_seed, _keep_mask,
                        _launch)

__all__ = ["splash_attention", "SplashAttention", "splash_attention_fwd",
           "splash_attention_dq", "splash_attention_dkv", "splash_supported",
           "sdpa_segment_reference", "_splash_fwd_reference",
           "_splash_dq_reference", "_splash_dkv_reference", "_block_bounds",
           "_subtile_mask", "_uniform_tiles"]


def _allowed(q_seg, kv_seg, causal):
    """bool [B, 1, Sq, Sk]: same segment, and key <= query under causal."""
    allowed = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
    if causal:
        Sq, Sk = q_seg.shape[1], kv_seg.shape[1]
        allowed = allowed & torch.ones(Sq, Sk, dtype=torch.bool,
                                       device=q_seg.device).tril()
    return allowed


def sdpa_segment_reference(q, k, v, q_seg, kv_seg, causal, scale):
    """Dense float32 reference with the kernels' segment semantics, the
    JAX package's formula (`splash_ops.py:68`): softmax of the masked
    scores, rows with no visible key set to zero. q/k/v [B,H,S,D],
    q_seg/kv_seg [B,S] int."""
    allowed = _allowed(q_seg, kv_seg, causal)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(torch.where(allowed, s, _NEG_INF), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return torch.where(allowed.any(-1, keepdim=True), out, 0.0).to(q.dtype)


# -- tile bounds --------------------------------------------------------------

def _block_bounds(q_seg, kv_seg, block_q, block_k, causal):
    """The tile spans the splash kernels visit (`splash_ops.py:93`).

    Returns int32 tensors on the ids' device, with no host wait:
      kv_lo, kv_hi [B, Sq / block_q]: the key tiles each query tile visits;
      q_lo, q_hi   [B, Sk / block_k]: the query tiles each key tile visits.
    A query tile holding segments s_first..s_last can only see keys from
    the first key of s_first to the last key of s_last (the ids are
    non-decreasing), found by `searchsorted`; causal also caps the span at
    the diagonal tile, as the flash kernels do. The CUDA kernels take
    block_q = block_k = 64 (`_KERNEL_TILE`)."""
    B, Sq = q_seg.shape
    Sk = kv_seg.shape[1]
    nqb, nkb = Sq // block_q, Sk // block_k
    q_seg, kv_seg = q_seg.contiguous(), kv_seg.contiguous()

    def ss(seq, vals, right):
        return torch.searchsorted(seq, vals.contiguous(), right=right)
    dev = q_seg.device
    kv_lo = ss(kv_seg, q_seg[:, ::block_q], False) // block_k
    kv_hi = -(-ss(kv_seg, q_seg[:, block_q - 1::block_q], True) // block_k)
    if causal:
        cap = (torch.arange(1, nqb + 1, device=dev) * block_q
               + block_k - 1) // block_k
        kv_hi = torch.minimum(kv_hi, cap[None, :])
    kv_hi = torch.maximum(kv_hi, kv_lo)          # an empty span, not negative
    q_lo = ss(q_seg, kv_seg[:, ::block_k], False) // block_q
    if causal:
        floor = torch.arange(nkb, device=dev) * block_k // block_q
        q_lo = torch.maximum(q_lo, floor[None, :])
    q_hi = -(-ss(q_seg, kv_seg[:, block_k - 1::block_k], True) // block_q)
    q_hi = torch.maximum(q_hi, q_lo)
    return tuple(t.to(torch.int32).contiguous()
                 for t in (kv_lo, kv_hi, q_lo, q_hi))


# the types K5-K7 are built for, with the C entries' dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SUB_ROWS, _SUB_COLS = 16, 8   # a warp's rows, an mma n-tile's columns


def _visited(lo, hi, S, cols):
    """bool [B, S/16, S/cols]: the block of 16 rows and `cols` columns
    lies in the span [lo, hi) (`_block_bounds` at 64) of its rows' 64-row
    tile."""
    dev = lo.device
    row_tile = torch.arange(S // _SUB_ROWS, device=dev) \
        // (_KERNEL_TILE // _SUB_ROWS)
    unit = (torch.arange(S // cols, device=dev) * cols
            // _KERNEL_TILE)[None, None, :]
    return (lo[:, row_tile, None] <= unit) & (unit < hi[:, row_tile, None])


def _subtile_mask(q_seg, kv_seg, causal, transposed=False):
    """The 16x8 sub-tiles of the scores, in the splash backward kernels'
    layout, that can hold an allowed pair: the share of the product work
    a sub-tile skip could keep. The kernels compute every sub-tile of a
    visited tile: skipping the others inside their unrolled products
    measured slower on the card (PERF.md §6). chip_smoke.py reports
    the share; the tests hold the rule.

    Returns bool tensors (visited, live), each [B, S/16, S/8]. For K6
    (`transposed` False) rows are blocks of 16 queries (a warp's) and
    columns groups of 8 keys (an mma n-tile); for K7 (`transposed` True)
    rows are blocks of 16 keys and columns groups of 8 queries.
    `visited`: the kernel's tile spans (`_block_bounds` at 64) reach the
    sub-tile. `live`: visited, and the id ranges of its rows and
    columns overlap (the ids are non-decreasing) and, under causal, its
    first key is at or before its last query; any other sub-tile holds
    P = 0 only."""
    B, S = q_seg.shape
    dev = q_seg.device
    rows, cols = (kv_seg, q_seg) if transposed else (q_seg, kv_seg)
    r = rows.reshape(B, S // _SUB_ROWS, _SUB_ROWS)
    c = cols.reshape(B, S // _SUB_COLS, _SUB_COLS)
    live = (r[..., 0, None] <= c[:, None, :, -1]) \
        & (r[..., -1, None] >= c[:, None, :, 0])
    if causal:
        r0 = torch.arange(0, S, _SUB_ROWS, device=dev)[:, None]
        c0 = torch.arange(0, S, _SUB_COLS, device=dev)[None, :]
        if transposed:   # rows are keys, columns queries
            live = live & (r0 <= c0 + _SUB_COLS - 1)
        else:
            live = live & (c0 <= r0 + _SUB_ROWS - 1)
    bounds = _block_bounds(q_seg, kv_seg, _KERNEL_TILE, _KERNEL_TILE, causal)
    lo, hi = bounds[2:] if transposed else bounds[:2]
    visited = _visited(lo, hi, S, _SUB_COLS)
    return visited, visited & live


def _uniform_tiles(q_seg, kv_seg, causal, key_tile):
    """The (16-row warp band, key tile) pairs of K5's loop that take its
    mask-free path: the softmax step with no per-element segment test.

    Returns bool tensors (visited, uniform), each [B, S/16, S/key_tile]:
    rows are a warp's 16 queries, columns K5's key tiles of `key_tile`
    keys (64, or 32 at head dim 128). `visited`: the tile lies in the
    span (`_block_bounds` at 64) of the band's 64-query tile. `uniform`:
    visited, and the band's first and last query ids and the tile's first
    and last key ids are one value (the ids are non-decreasing, so the
    band and the tile then lie in one segment) and, under causal, the
    tile's last key is at or before the band's first query: every pair
    of the two is allowed."""
    B, S = q_seg.shape
    dev = q_seg.device
    band = q_seg.reshape(B, S // _SUB_ROWS, _SUB_ROWS)
    tile = kv_seg.reshape(B, S // key_tile, key_tile)
    q_one = band[..., 0] == band[..., -1]
    k_one = tile[..., 0] == tile[..., -1]
    uniform = (q_one[..., None] & k_one[:, None, :]
               & (band[..., 0, None] == tile[:, None, :, 0]))
    if causal:
        r0 = torch.arange(0, S, _SUB_ROWS, device=dev)[:, None]
        c_last = torch.arange(key_tile - 1, S, key_tile, device=dev)[None, :]
        uniform = uniform & (c_last <= r0)
    lo, hi = _block_bounds(q_seg, kv_seg, _KERNEL_TILE, _KERNEL_TILE,
                           causal)[:2]
    visited = _visited(lo, hi, S, key_tile)
    return visited, visited & uniform


# -- plain versions --------------------------------------------------------------

def _scores(q, k, scale):
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale


def _splash_fwd_reference(q, k, v, q_seg, kv_seg, causal, scale,
                          dropout_p=0.0, seed=0):
    """The plain forward, as K5 computes it: masked scores, P = exp(S - m)
    zeroed where masked, l = rowsum(P) before dropout, O = dropped P V /
    l_safe (l_safe = l, or 1 for a row with no visible key) in q's type;
    and LSE = m + log(l_safe) [B*H, Sq] float32. Differentiable in q, k
    and v."""
    B, H, Sq, _ = q.shape
    allowed = _allowed(q_seg, kv_seg, causal)
    s = torch.where(allowed, _scores(q, k, scale), _NEG_INF)
    m = s.amax(-1, keepdim=True).detach()   # the result does not depend on m
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l > 0, l, 1.0)
    lse = (m + torch.log(l_safe)).reshape(B * H, Sq)
    if dropout_p > 0.0:
        keep = _keep_mask(seed, B, H, Sq, k.shape[2], dropout_p, q.device)
        p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l_safe
    return out.to(q.dtype), lse


def _splash_bwd_terms(q, k, v, q_seg, kv_seg, dout, lse, delta, causal,
                      scale, dropout_p, seed):
    """dS and the dropped P, recomputed as K6/K7 do: P = exp(S - lse),
    zeroed where masked OUTSIDE the exp (a row with no visible key has
    lse -1e30, which must not turn its entries into exp(0) = 1); dP = dO
    V^T masked and scaled by the keep mask; dS = P (dP - delta)."""
    B, H, Sq, _ = q.shape
    allowed = _allowed(q_seg, kv_seg, causal)
    p = torch.where(allowed, torch.exp(_scores(q, k, scale)
                                       - lse.reshape(B, H, Sq, 1)), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    pd = p
    if dropout_p > 0.0:
        keep = _keep_mask(seed, B, H, Sq, k.shape[2], dropout_p, q.device)
        dp = torch.where(keep, dp / (1.0 - dropout_p), 0.0)
        pd = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    return p * (dp - delta.reshape(B, H, Sq, 1)), pd


def _splash_dq_reference(q, k, v, q_seg, kv_seg, dout, lse, delta, causal,
                         scale, dropout_p=0.0, seed=0):
    """The plain dQ = scale * dS K, in q's type."""
    ds, _ = _splash_bwd_terms(q, k, v, q_seg, kv_seg, dout, lse, delta,
                              causal, scale, dropout_p, seed)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
            ).to(q.dtype)


def _splash_dkv_reference(q, k, v, q_seg, kv_seg, dout, lse, delta, causal,
                          scale, dropout_p=0.0, seed=0):
    """The plain dK = scale * dS^T Q and dV = Pd^T dO, in k's type."""
    ds, pd = _splash_bwd_terms(q, k, v, q_seg, kv_seg, dout, lse, delta,
                               causal, scale, dropout_p, seed)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", pd, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- the gates ---------------------------------------------------------------------

def splash_supported(q_shape, k_shape=None, v_shape=None, is_causal=False,
                     min_seq=None):
    """Static gate (`splash_ops.py:472`): strict self-attention (k and v
    shaped like q: packed rows), sequence length a multiple of 128 and at
    least FLAGS_splash_attention_min_seq, and a head dim the kernels are
    built for (32/64/128)."""
    if len(q_shape) != 4:
        return False
    B, H, Sq, D = q_shape
    k_shape = tuple(k_shape) if k_shape is not None else tuple(q_shape)
    v_shape = tuple(v_shape) if v_shape is not None else k_shape
    if k_shape != v_shape or k_shape != (B, H, Sq, D):
        return False
    if Sq % _BLOCK_MIN != 0 or D not in _HEAD_DIMS:
        return False
    if min_seq is None:
        min_seq = flag("FLAGS_splash_attention_min_seq")
    return Sq >= min_seq


def _check_monotonic(seg):
    """Raise on a row whose segment id decreases: the tile bounds assume
    non-decreasing ids and would drop attention silently. Checked for
    numpy arrays and CPU tensors only: reading a CUDA tensor's values
    would make the host wait for the card on every call, so those are
    trusted, as the JAX package trusts traced ids it cannot read (there
    the packing collator is the producer)."""
    if torch.is_tensor(seg):
        if seg.is_cuda:
            return
        bad = seg.dim() == 2 and bool((torch.diff(seg, dim=1) < 0).any())
    else:
        arr = np.asarray(seg)
        bad = arr.ndim == 2 and bool(np.any(np.diff(arr, axis=1) < 0))
    if bad:
        raise ValueError(
            "splash attention requires NON-DECREASING segment ids along "
            "each row (the packing layout); got a row with a decreasing "
            "id — re-pack or route through dense attention")


# -- the kernels ---------------------------------------------------------------------

# source -> (C entry, its error-string function, number of pointer arguments)
_ENTRIES = {
    "splash_fwd.cu": ("splash_attention_forward",
                      "splash_fwd_error_string", 9),
    "splash_bwd_dq.cu": ("splash_attention_bwd_dq",
                         "splash_bwd_dq_error_string", 11),
    "splash_bwd_dkv.cu": ("splash_attention_bwd_dkv",
                          "splash_bwd_dkv_error_string", 12),
}


def _check_ids(q, q_seg, kv_seg, bounds):
    """What the kernels take beyond flash_ops._check: strict self-attention,
    int32 [B, S] segment ids (16-byte aligned) and int32 [B, S / 64] tile
    bounds, contiguous on q's device."""
    B, H, S, D = q.shape
    want = {"q_seg": (q_seg, (B, S)), "kv_seg": (kv_seg, (B, S)),
            "lo": (bounds[0], (B, S // _KERNEL_TILE)),
            "hi": (bounds[1], (B, S // _KERNEL_TILE))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.int32 \
                or t.device != q.device or not t.is_contiguous():
            raise InvalidArgumentError(
                f"splash kernels: {name} must be contiguous int32 {shape} "
                f"on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    for name, t in (("q_seg", q_seg), ("kv_seg", kv_seg)):
        if t.data_ptr() % 16:   # K5-K7 copy ids in 16-byte pieces
            raise InvalidArgumentError(
                f"splash kernels: {name} must start on a 16-byte boundary")


def _kernel_args(q, k, v, q_seg, kv_seg, causal, bounds, which, **rest):
    """Check a CUDA launch's operands; returns its (lo, hi) bounds, computed
    here when the caller passed none (`which` 0: the key spans of K5/K6,
    2: the query spans of K7)."""
    _check(q, k, v, None, dtypes=_DTYPES, **rest)
    if tuple(k.shape) != tuple(q.shape):
        raise InvalidArgumentError(
            f"splash kernels: self-attention only, q {tuple(q.shape)} k "
            f"{tuple(k.shape)}")
    if bounds is None:
        b = _block_bounds(q_seg, kv_seg, _KERNEL_TILE, _KERNEL_TILE, causal)
        bounds = b[which:which + 2]
    _check_ids(q, q_seg, kv_seg, bounds)
    return bounds


def splash_attention_fwd(q, k, v, q_seg, kv_seg, causal=False, scale=None,
                         dropout_p=0.0, seed=0, bounds=None):
    """Splash-attention forward. q/k/v [B,H,S,D]; q_seg/kv_seg [B,S] int32
    non-decreasing; `bounds` the (kv_lo, kv_hi) of `_block_bounds` at
    the kernel tile, computed when None. Returns (out [B,H,S,D] in q's
    type, lse [B*H, S] float32).

    A CUDA `q` launches kernel K5 (or raises); a CPU `q` runs the plain
    version. `splash_attention_fwd.launches` counts kernel launches."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return _splash_fwd_reference(q, k, v, q_seg, kv_seg, causal, scale,
                                     dropout_p, seed)
    lo, hi = _kernel_args(q, k, v, q_seg, kv_seg, causal, bounds, 0)
    B, H, S, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    _launch("splash_fwd.cu", (q, k, v, q_seg, kv_seg, lo, hi, out, lse), q,
            k, causal, scale, dropout_p, seed, entries=_ENTRIES)
    _count(splash_attention_fwd, q.dtype)
    monitor.stat_add("STAT_splash_attention_fwd")
    return out, lse


def splash_attention_dq(q, k, v, q_seg, kv_seg, dout, lse, delta, causal,
                        scale, dropout_p=0.0, seed=0, bounds=None):
    """dQ of splash attention from the forward's `lse` and `delta =
    rowsum(dO * O)` ([B*H, S] float32 each); `bounds` as for the
    forward. A CUDA `q` launches kernel K6 (or raises); a CPU `q` runs
    `_splash_dq_reference`. `splash_attention_dq.launches` counts kernel
    launches."""
    if not q.is_cuda:
        return _splash_dq_reference(q, k, v, q_seg, kv_seg, dout, lse, delta,
                                    causal, scale, dropout_p, seed)
    lo, hi = _kernel_args(q, k, v, q_seg, kv_seg, causal, bounds, 0,
                          dout=dout, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    _launch("splash_bwd_dq.cu", (q, k, v, q_seg, kv_seg, lo, hi, dout, lse,
                                 delta, dq), q, k, causal, scale, dropout_p,
            seed, entries=_ENTRIES)
    _count(splash_attention_dq, q.dtype)
    monitor.stat_add("STAT_splash_attention_bwd")
    return dq


def splash_attention_dkv(q, k, v, q_seg, kv_seg, dout, lse, delta, causal,
                         scale, dropout_p=0.0, seed=0, bounds=None):
    """(dK, dV) of splash attention, inputs as `splash_attention_dq` but
    `bounds` the (q_lo, q_hi) of `_block_bounds`. A CUDA `q` launches
    kernel K7 (or raises); a CPU `q` runs `_splash_dkv_reference`.
    `splash_attention_dkv.launches` counts kernel launches."""
    if not q.is_cuda:
        return _splash_dkv_reference(q, k, v, q_seg, kv_seg, dout, lse,
                                     delta, causal, scale, dropout_p, seed)
    lo, hi = _kernel_args(q, k, v, q_seg, kv_seg, causal, bounds, 2,
                          dout=dout, lse=lse, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("splash_bwd_dkv.cu", (q, k, v, q_seg, kv_seg, lo, hi, dout, lse,
                                  delta, dk, dv), q, k, causal, scale,
            dropout_p, seed, entries=_ENTRIES)
    _count(splash_attention_dkv, q.dtype)
    monitor.stat_add("STAT_splash_attention_bwd")
    return dk, dv


for _w in (splash_attention_fwd, splash_attention_dq, splash_attention_dkv):
    _w.launches = 0
    _w.launches_by_dtype = collections.Counter()


# -- autograd and the framework entry ---------------------------------------------

class SplashAttention(torch.autograd.Function):
    """Splash attention with O(S·D) memory in forward and backward. The
    forward computes the tile bounds once (on a CUDA `q`) and saves them
    with (q, k, v, ids, out, lse); the backward recomputes P from (q, k,
    lse) and replays the same keep mask. Segment ids and seed get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, seed, causal, scale, dropout_p):
        bounds = (_block_bounds(q_seg, kv_seg, _KERNEL_TILE, _KERNEL_TILE,
                                causal) if q.is_cuda else (None,) * 4)
        out, lse = splash_attention_fwd(
            q, k, v, q_seg, kv_seg, causal, scale, dropout_p, seed,
            bounds=bounds[:2] if q.is_cuda else None)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse, *bounds)
        ctx.args = (causal, scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qs, ks, out, lse, kv_lo, kv_hi, q_lo, q_hi = \
            ctx.saved_tensors
        dout = dout.contiguous()
        delta = _delta(out, dout)
        cuda = q.is_cuda
        dq = splash_attention_dq(q, k, v, qs, ks, dout, lse, delta,
                                 *ctx.args,
                                 bounds=(kv_lo, kv_hi) if cuda else None)
        dk, dv = splash_attention_dkv(q, k, v, qs, ks, dout, lse, delta,
                                      *ctx.args,
                                      bounds=(q_lo, q_hi) if cuda else None)
        return dq, dk, dv, None, None, None, None, None, None


def _ids(seg, device):
    """Segment ids (tensor, numpy array or nested list) as contiguous int32
    on `device`."""
    if not torch.is_tensor(seg):
        seg = torch.from_numpy(np.ascontiguousarray(np.asarray(seg)))
    return seg.to(device=device, dtype=torch.int32).contiguous()


def splash_attention(query, key, value, q_seg, kv_seg, causal=False,
                     scale=None, dropout_p=0.0, generator=None):
    """Framework-level entry, differentiable in query, key and value.

    q_seg/kv_seg: [B, S] int segment ids (tensor or array), non-decreasing
    per row; a pack's padding carries its own trailing segment id, so pad
    tokens only ever attend to each other. With dropout, the int32 seed
    of the keep mask comes from `generator` when given, else from
    `framework.random.next_seed` for the query's device. The AMP op
    "splash_attention" is in no list: q/k/v keep their type unless a
    custom list of `auto_cast` names it."""
    query, key, value = amp.cast_args("splash_attention", query, key, value)
    if scale is None:
        scale = 1.0 / (query.shape[-1] ** 0.5)
    _check_monotonic(q_seg)
    _check_monotonic(kv_seg)
    seed = _dropout_seed(query.device, dropout_p, generator)
    return SplashAttention.apply(
        query.contiguous(), key.contiguous(), value.contiguous(),
        _ids(q_seg, query.device), _ids(kv_seg, query.device), seed,
        bool(causal), float(scale), float(dropout_p))
