"""Paged KV-cache attention: the CUDA decode kernel and its plain version.

Decode-time K/V lives in fixed-size pages inside preallocated per-layer
pools (`[L, H, num_pages, page_size, D]`), and a per-sequence page table
maps logical positions to physical pages (`serving/kv_cache.py`).

`paged_attention` has two implementations of one function:

- **CUDA tensors** launch the hand-written kernel
  `csrc/paged_attention.cu` (K1), which reads pages in place up to each
  sequence's length. It replaces the Pallas kernel the JAX package
  dispatches on a TPU. K1 is split-K (flash-decoding): one launch of the
  C entry runs two kernels, the first cutting each sequence into splits
  of whole pages (`_pages_per_split`) that write partials (acc, max,
  sum) into a float32 workspace the wrapper allocates, the second
  merging them; one call is one `.launches`. K1 serves every head dim
  up to 512: D % 8 == 0 and D <= 256 at D itself with 16-byte loads, any
  other D at a padded power-of-two width with one-value loads masked at
  D. A larger D raises `InvalidArgumentError` (`_check_kernel_args`),
  never the plain version.
- **CPU tensors** run the plain version: gather the page table into a
  dense `[B, H, T, D]` buffer and run `cached_attention`, the masked
  softmax `GPTForCausalLM.generate`'s dense cache uses (positions beyond
  `pos` mask to -1e30, so page-tail junk contributes exactly 0).

`STAT_paged_attn_kernel` / `STAT_paged_attn_reference` count calls. K1
is the registered op `paddle_tpu_torch::paged_attention` (a fake
implementation gives its shape to `torch.export`), so a program exported
on either device holds the op and launches K1 once it runs on the card.

The prefix-cache tail prefill and the speculative verify step attend
multi-position queries over cached pages plus their own in-flight K/V:
`paged_gather_layers` + `paged_prefix_attention`. The JAX package
computes these with plain jnp outside any Pallas kernel, and so they are
plain PyTorch here, on the card too.

**int8 pages** (`kv_cache_dtype="int8"`): the pools store int8 with a
per-(layer, head, page) float32 scale pool (symmetric abs-max; dequant =
q * scale). `paged_write_quantized` quantizes on append: a decode append
whose abs-max exceeds its page's scale requantizes the page's content
onto the wider grid (round(q * old / new)); a prefill builds each target
page's scale by a duplicate-safe scatter-max over every token landing in
it, then quantizes every token against its page's final scale (and with
`requant=True`, for pages that arrive with content, first requantizes
that content). Reads dequantize on gather (`paged_gather_quantized`,
`paged_gather_layers(scales=...)`), materializing only this batch's
pages in float. `paged_attention` with `k_scales`/`v_scales` takes that
dequantizing gather + `cached_attention` and launches no K1, exactly as
the JAX package never hands int8 pools to its Pallas kernel
(`paddle_tpu/ops/paged_ops.py:232-238`). Scale 0 marks an empty page
(zero-on-free resets both pools). `STAT_kv_quant_writes` /
`STAT_kv_quant_reads` count the calls.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..framework import monitor
from ..framework.errors import InvalidArgumentError
from ..framework.flags import flag
from . import _build

__all__ = ["cached_attention", "paged_attention", "paged_attention_plain",
           "paged_gather", "paged_gather_layers", "paged_gather_quantized",
           "paged_prefix_attention", "paged_write", "paged_write_quantized",
           "page_rows_for_positions", "sharded_paged_attention"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 512    # K1 serves every head dim up to this (see the .cu)


def cached_attention(q, kb, vb, pos, scale):
    """Masked attention of one-position queries over a dense cache.

    q [B, H, D]; kb/vb [B, H, T, D]; pos an int or [B] int tensor (the
    LAST valid cache position — attention covers t <= pos). Returns
    [B, H, D]."""
    s = torch.einsum("bhd,bhtd->bht", q, kb) * scale
    T = kb.shape[2]
    t = torch.arange(T, device=kb.device)
    if torch.is_tensor(pos) and pos.dim():
        allowed = t[None, None, :] <= pos.to(kb.device)[:, None, None]
    else:
        allowed = (t <= int(pos))[None, None, :]
    # -1e30 in s's type by conversion: -inf in float16, as the JAX
    # package's jnp.where(..., s, -1e30) gives
    s = torch.where(allowed, s, torch.full((), _NEG, device=s.device)
                    .to(s.dtype))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhtd->bhd", p, vb)


def paged_gather(pages, page_table):
    """Materialize page-table rows as a dense cache view.

    pages [H, N, P, D] (one layer's pool); page_table [B, PP] int.
    Returns [B, H, PP*P, D] in logical token order."""
    H, _, P, D = pages.shape
    B, PP = page_table.shape
    kb = pages[:, page_table.long()]            # [H, B, PP, P, D]
    return kb.movedim(1, 0).reshape(B, H, PP * P, D)


def paged_gather_layers(pages, page_table, scales=None,
                        dtype=torch.float32):
    """ONE sequence's page-table row as a dense view across ALL layers at
    once: pages [L, H, N, P, D] + page_table [PP] -> [L, H, PP*P, D]
    (dequantized to `dtype` through the per-page `scales` [L, H, N] of
    the int8 mode). One gather of this row's pages instead of a per-layer
    slice of the pool."""
    L, H, _, P, D = pages.shape
    PP = page_table.shape[0]
    idx = page_table.long()
    kb = pages[:, :, idx]                       # [L, H, PP, P, D]
    if scales is not None:
        monitor.stat_add("STAT_kv_quant_reads")
        sc = scales[:, :, idx]                  # [L, H, PP]
        kb = kb.to(dtype) * sc[..., None, None].to(dtype)
    return kb.reshape(L, H, PP * P, D)


def paged_prefix_attention(q, kb, vb, k_tail, v_tail, prefix_len, scale):
    """Tail-prefill attention: multi-position queries over a cached
    prefix (gathered from pages) plus the tail's own in-flight K/V.

    q / k_tail / v_tail [B, H, S, D]; kb/vb [B, H, T, D] (one layer of a
    gathered page-table view); prefix_len an int (or 0-d tensor), or a
    [B] int tensor of per-row context lengths (the speculative verify
    block: every decode slot has its own cache length). Cached positions
    t < prefix_len are attended; everything at or past it in the gathered
    view (fresh pages, table padding) masks to -1e30, an exact 0.0 after
    the softmax. Tail position j is attended by tail query i iff j <= i.
    The joint softmax over [prefix ; tail] is `cached_attention`'s masked
    expression, the JAX package's `paged_prefix_attention`. Returns
    [B, H, S, D]."""
    monitor.stat_add("STAT_paged_attn_reference")
    T = kb.shape[2]
    S = q.shape[2]
    neg = torch.full((), _NEG, device=q.device).to(q.dtype)  # fp16: -inf
    sp = torch.einsum("bhsd,bhtd->bhst", q, kb) * scale
    t = torch.arange(T, device=q.device)
    if torch.is_tensor(prefix_len) and prefix_len.dim():
        limit = prefix_len.to(q.device).long()[:, None, None, None]
    else:
        limit = int(prefix_len)
    sp = torch.where(t[None, None, None, :] < limit, sp, neg)
    st = torch.einsum("bhsd,bhtd->bhst", q, k_tail) * scale
    i = torch.arange(S, device=q.device)
    st = torch.where((i[:, None] >= i[None, :])[None, None], st, neg)
    p = torch.softmax(torch.cat([sp, st], dim=-1), dim=-1)
    return (torch.einsum("bhst,bhtd->bhsd", p[..., :T], vb)
            + torch.einsum("bhst,bhtd->bhsd", p[..., T:], v_tail))


def page_rows_for_positions(page_table, positions, page_size):
    """(page_ids, offsets) physical coordinates for logical `positions`.

    page_table [PP] or [B, PP]; positions [S] (with a [PP] table), [B]
    (with a [B, PP] table — one position per row), or [B, S] (with a
    [B, PP] table). Out-of-range page indices clamp onto the row's last
    entry, as the JAX package's gather does."""
    positions = positions.long()
    idx = torch.div(positions, page_size, rounding_mode="floor")
    offs = positions % page_size
    if page_table.dim() == 1:
        idx = idx.clamp(0, page_table.shape[0] - 1)
        return page_table[idx], offs
    B, PP = page_table.shape
    idx = idx.clamp(0, PP - 1)
    if positions.dim() == 2:
        rows = torch.arange(B, device=page_table.device)[:, None]
        return page_table[rows, idx], offs
    return page_table[torch.arange(B, device=page_table.device), idx], offs


def paged_write(pages, layer, page_ids, offsets, values):
    """Scatter K/V vectors into a paged pool, IN PLACE; returns `pages`.

    pages [L, H, N, P, D]. With an int `layer`: page_ids/offsets [B],
    values [B, H, D]. With `layer=None` (prefill, all layers at once):
    page_ids/offsets [S], values [L, H, S, D]. Duplicate coordinates (pad
    positions and parked slots routed to the scratch page) keep one of
    the writes; the scratch page is masked junk either way."""
    page_ids, offsets = page_ids.long(), offsets.long()
    if layer is None:
        pages[:, :, page_ids, offsets, :] = values.to(pages.dtype)
    else:
        pages[layer][:, page_ids, offsets, :] = \
            values.movedim(0, 1).to(pages.dtype)
    return pages


# -- int8 pages ---------------------------------------------------------------

def _q8(v, s):
    """Symmetric int8 quantization of `v` against per-slice scales `s`
    (broadcastable); s == 0 (an empty or all-zero slice) maps to 0."""
    pos = s > 0
    q = torch.where(pos, v / torch.where(pos, s, torch.ones_like(s)),
                    torch.zeros_like(v))
    return torch.clamp(torch.round(q), -127, 127).to(torch.int8)


def _per127(a):
    """a / 127 as a tensor division (a Python divisor may run as a
    multiplication by its reciprocal, which rounds otherwise)."""
    return a / torch.full_like(a, 127.0)


def _ratio(s_old, s_new):
    """old / new grid ratio of a requantization; 1 where the new scale
    is 0 (an empty page)."""
    pos = s_new > 0
    return torch.where(pos, s_old / torch.where(pos, s_new,
                                                torch.ones_like(s_new)),
                       torch.ones_like(s_new))


def paged_gather_quantized(pages, scales, page_table, dtype=torch.float32):
    """Dequantizing gather: int8 pages [H, N, P, D] + scales [H, N] ->
    dense `dtype` [B, H, PP*P, D] (only THIS batch's pages are ever
    materialized in float; the pools stay int8 on the device)."""
    monitor.stat_add("STAT_kv_quant_reads")
    H, _, P, D = pages.shape
    B, PP = page_table.shape
    idx = page_table.long()
    kb = pages[:, idx]                          # [H, B, PP, P, D]
    sc = scales[:, idx]                         # [H, B, PP]
    kb = kb.to(dtype) * sc[..., None, None].to(dtype)
    return kb.movedim(1, 0).reshape(B, H, PP * P, D)


def paged_write_quantized(pages, scales, layer, page_ids, offsets, values,
                          requant=False):
    """Quantize-on-append into int8 pools, IN PLACE; returns (pages,
    scales).

    Decode (`layer` an int): page_ids/offsets [B], values [B, H, D]. Each
    row's page grows its scale to cover the new token, requantizing its
    content onto the wider grid when it does, and the token is written
    quantized. Duplicate page ids (inactive slots parked on the scratch
    page) keep one of the writes: scratch content is masked junk.

    Prefill (`layer=None`): page_ids/offsets [S], values [L, H, S, D]. A
    scatter-max (duplicate-safe) builds each target page's scale over every
    token landing in it, then every token quantizes against its page's
    final scale. Target pages are assumed freshly zeroed (scale 0, what
    zero-on-free guarantees for an alloc) unless `requant=True`: the tail
    program, a verify commit or a chunk writes onto pages that hold
    content and a non-zero scale, and their content is first requantized
    onto the (possibly widened) grid. Duplicate page ids compute identical
    requantized pages, so their writes agree."""
    monitor.stat_add("STAT_kv_quant_writes")
    page_ids, offsets = page_ids.long(), offsets.long()
    fdt = values.dtype
    # mixed float operands promote as jnp's do (bf16 x fp32 -> fp32)
    if layer is None:
        L, H, S = values.shape[:3]
        a = _per127(values.abs().amax(-1))                   # [L, H, S]
        s_old = scales[:, :, page_ids]                       # [L, H, S]
        scales.scatter_reduce_(2, page_ids.expand(L, H, S),
                               a.to(scales.dtype), "amax",
                               include_self=True)
        s_tok = scales[:, :, page_ids]                       # [L, H, S]
        if requant:
            pk = pages[:, :, page_ids]                       # [L,H,S,P,D]
            ratio = _ratio(s_old, s_tok)
            pages[:, :, page_ids] = torch.round(
                pk.to(fdt) * ratio[..., None, None]).to(torch.int8)
        pages[:, :, page_ids, offsets, :] = _q8(values, s_tok[..., None])
        return pages, scales
    B = page_ids.shape[0]
    a = _per127(values.abs().amax(-1))                       # [B, H]
    s_old = scales[layer][:, page_ids]                       # [H, B]
    s_new = torch.maximum(s_old, a.t().to(s_old.dtype))      # [H, B]
    pk = pages[layer][:, page_ids]                           # [H, B, P, D]
    ratio = _ratio(s_old, s_new)
    pk = torch.round(pk.to(fdt) * ratio[..., None, None]).to(torch.int8)
    q = _q8(values, s_new.t()[..., None])                    # [B, H, D]
    pk[:, torch.arange(B, device=pk.device), offsets, :] = q.movedim(0, 1)
    pages[layer][:, page_ids] = pk
    scales[layer][:, page_ids] = s_new
    return pages, scales


def paged_attention_plain(q, k_pages, v_pages, page_table, pos, scale):
    """The plain PyTorch version of kernel K1: dense gather + masked
    softmax (`paged_gather` + `cached_attention`)."""
    kb = paged_gather(k_pages, page_table).to(q.dtype)
    vb = paged_gather(v_pages, page_table).to(q.dtype)
    return cached_attention(q, kb, vb, pos, scale)


_SPLIT_TOKENS = 16     # tokens K1 gives one split (one warp), at least
_K1_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


def _pages_per_split(page_size):
    """Whole pages a split of K1 takes: the fewest that hold 16 tokens."""
    return max(1, -(-_SPLIT_TOKENS // page_size))


def _check_kernel_args(q, k_pages, v_pages, page_table, pos):
    """What K1 takes, checked without building or launching anything:
    float32, bfloat16 or float16 q [B, H, D] and pools [H, N, P, D] of one
    type, a head dim D <= 512 (D % 8 == 0 and D <= 256 at D itself, any
    other at a padded width), int32 page_table [B, PP] and pos [B],
    everything contiguous on q's device. Raises InvalidArgumentError on
    anything else."""
    H, N, P, D = k_pages.shape
    B, PP = page_table.shape
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise InvalidArgumentError(
            f"paged_attention kernel takes float32, bfloat16 or float16 q "
            f"and pools of one type, got {q.dtype}/{k_pages.dtype}/"
            f"{v_pages.dtype}")
    if not 0 < D <= _MAX_HEAD_DIM:
        raise InvalidArgumentError(
            f"paged_attention kernel: head_dim {D} is not served; K1 takes "
            f"head dims D <= {_MAX_HEAD_DIM}")
    if tuple(q.shape) != (B, H, D) \
            or tuple(v_pages.shape) != tuple(k_pages.shape):
        raise InvalidArgumentError(
            f"paged_attention kernel: q {tuple(q.shape)}, pools "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, table "
            f"{tuple(page_table.shape)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("pos", pos)):
        if t.device != q.device:
            raise InvalidArgumentError(
                f"paged_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise InvalidArgumentError(
                f"paged_attention: {name} must be contiguous")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32 \
            or tuple(pos.shape) != (B,):
        raise InvalidArgumentError(
            "paged_attention: page_table [B, PP] and pos [B] must be int32")


@functools.lru_cache(maxsize=None)
def _workspace_width(D):
    """The width of a K1 workspace row less its two statistics
    (`paged_attention_workspace_width` of csrc/paged_attention.cu)."""
    fn = _build.function("paged_attention.cu",
                         "paged_attention_workspace_width", [ctypes.c_int],
                         ctypes.c_int)
    return int(fn(D))


def _launch_paged_kernel(q, k_pages, v_pages, page_table, pos, scale):
    """K1 on the card. Checks what the kernel takes and raises on
    anything else; never falls back to the plain version."""
    _check_kernel_args(q, k_pages, v_pages, page_table, pos)
    H, N, P, D = k_pages.shape
    B, PP = page_table.shape
    fn = _build.function("paged_attention.cu", "paged_attention_decode",
                         _K1_ARGTYPES)
    pps = _pages_per_split(P)
    out = torch.empty_like(q)
    # the splits' partials (acc[W], max, sum), written and merged by K1; W
    # is D, or the padded width K1 runs D at
    ws = torch.empty(B, H, -(-PP // pps), _workspace_width(D) + 2,
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), B, H, N, P, PP, pps, D, _DTYPES[q.dtype],
                 float(scale), stream)
    if err:
        es = _build.function("paged_attention.cu",
                             "paged_attention_error_string", [ctypes.c_int],
                             ctypes.c_char_p)
        raise RuntimeError(
            f"paged_attention kernel launch failed: {es(err).decode()}")
    paged_attention.launches += 1
    paged_attention.launches_by_dtype[
        str(q.dtype).replace("torch.", "")] += 1
    return out


def paged_attention(q, k_pages, v_pages, page_table, pos, scale,
                    k_scales=None, v_scales=None):
    """One decode position of attention over a paged KV cache.

    q [B, H, D]; k_pages/v_pages [H, N, P, D] (ONE layer's pool);
    page_table [B, PP] int32; pos [B] int32 (last valid position, the
    token just written). Returns [B, H, D].

    int8 pools pass k_scales/v_scales ([H, N] per-page scales): they take
    the dequantizing gather + `cached_attention` on every device, and K1
    is not launched (the JAX package hands int8 pools to no kernel).
    Otherwise the call goes through the registered op
    `paddle_tpu_torch::paged_attention`, whose dispatch picks the
    implementation from q's device when the call runs: a CUDA `q`
    launches kernel K1 (or raises: K1 serves head dims up to 512), a CPU
    `q` runs `paged_attention_plain`; FLAGS_use_paged_attention off runs
    `paged_attention_plain` without the op. `paged_attention.launches` counts kernel
    launches, and `.launches_by_dtype` counts them by q's type
    ("float16")."""
    if k_scales is not None:
        monitor.stat_add("STAT_paged_attn_reference")
        kb = paged_gather_quantized(k_pages, k_scales, page_table, q.dtype)
        vb = paged_gather_quantized(v_pages, v_scales, page_table, q.dtype)
        return cached_attention(q, kb, vb, pos, scale)
    if flag("FLAGS_use_paged_attention"):
        return torch.ops.paddle_tpu_torch.paged_attention(
            q, k_pages, v_pages, page_table, pos, float(scale))
    monitor.stat_add("STAT_paged_attn_reference")
    return paged_attention_plain(q, k_pages, v_pages, page_table, pos, scale)


paged_attention.launches = 0
paged_attention.launches_by_dtype = collections.Counter()


@torch.library.custom_op("paddle_tpu_torch::paged_attention",
                         mutates_args=(), device_types="cpu")
def _paged_attention_op(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        pos: torch.Tensor, scale: float) -> torch.Tensor:
    """K1 as a registered op, so a `torch.export` program (the serving
    program store's decode programs) holds it and picks the
    implementation from q's device when it runs. The CPU implementation
    is the plain version, looked up at call time."""
    monitor.stat_add("STAT_paged_attn_reference")
    return paged_attention_plain(q, k_pages, v_pages, page_table, pos, scale)


@_paged_attention_op.register_kernel("cuda")
def _paged_attention_cuda(q, k_pages, v_pages, page_table, pos, scale):
    """The op's CUDA implementation: kernel K1, or InvalidArgumentError
    for operands it does not take (never the plain version)."""
    monitor.stat_add("STAT_paged_attn_kernel")
    return _launch_paged_kernel(q, k_pages, v_pages, page_table, pos, scale)


@_paged_attention_op.register_fake
def _paged_attention_fake(q, k_pages, v_pages, page_table, pos, scale):
    """Shape and type for tracing: the output is like q."""
    return q.new_empty(q.shape)


def sharded_paged_attention(mesh, scale, tp_axis="tp", quantized=False):
    """KV-head-sharded `paged_attention` of a tensor-parallel rank (the JAX
    package's `sharded_paged_attention`, which wraps the kernel in
    `shard_map` over `tp`). A rank holds its heads already: q [B, H/tp,
    D], one layer's pools [H/tp, N, P, D] (and, with `quantized`, the
    scale grids [H/tp, N]), the page table and positions whole. Returns
    `f(q, k_pages, v_pages, page_table, pos)`, or with `quantized`
    `f(q, k_pages, v_pages, k_scales, v_scales, page_table, pos)`,
    giving [B, H/tp, D]: kernel K1 on the rank's heads on the card (the
    int8 pools take the dequantizing gather, as unsharded)."""
    if quantized:
        def f(q, kp, vp, ks, vs, pt, pos):
            return paged_attention(q, kp, vp, pt, pos, scale, ks, vs)
    else:
        def f(q, kp, vp, pt, pos):
            return paged_attention(q, kp, vp, pt, pos, scale)
    return f
