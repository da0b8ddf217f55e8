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
  D with D % 8 == 0 and D <= 256; any other D raises
  `InvalidArgumentError` (`_check_kernel_args`), never the plain version.
- **CPU tensors** run the plain version: gather the page table into a
  dense `[B, H, T, D]` buffer and run `cached_attention`, the masked
  softmax `GPTForCausalLM.generate`'s dense cache uses (positions beyond
  `pos` mask to -1e30, so page-tail junk contributes exactly 0).

`STAT_paged_attn_kernel` / `STAT_paged_attn_reference` count calls.
"""
from __future__ import annotations

import ctypes

import torch

from ..framework import monitor
from ..framework.errors import InvalidArgumentError
from ..framework.flags import flag
from . import _build

__all__ = ["cached_attention", "paged_attention", "paged_attention_plain",
           "paged_gather", "paged_write", "page_rows_for_positions"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256    # K1 is built for every multiple of 8 up to this


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
    s = torch.where(allowed, s, torch.full((), _NEG, dtype=s.dtype,
                                           device=s.device))
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
    float32 or bfloat16 q [B, H, D] and pools [H, N, P, D] of one type,
    a head dim D with D % 8 == 0 and D <= 256, int32 page_table [B, PP]
    and pos [B], everything contiguous on q's device. Raises
    InvalidArgumentError on anything else."""
    H, N, P, D = k_pages.shape
    B, PP = page_table.shape
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise InvalidArgumentError(
            f"paged_attention kernel takes float32 or bfloat16 q and pools "
            f"of one type, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if not (0 < D <= _MAX_HEAD_DIM and D % 8 == 0):
        raise InvalidArgumentError(
            f"paged_attention kernel: head_dim {D} is not served; K1 takes "
            f"head dims D with D % 8 == 0 and D <= {_MAX_HEAD_DIM}")
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
    # the splits' partials (acc[D], max, sum), written and merged by K1
    ws = torch.empty(B, H, -(-PP // pps), D + 2, dtype=torch.float32,
                     device=q.device)
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
    return out


def paged_attention(q, k_pages, v_pages, page_table, pos, scale):
    """One decode position of attention over a paged KV cache.

    q [B, H, D]; k_pages/v_pages [H, N, P, D] (ONE layer's pool);
    page_table [B, PP] int32; pos [B] int32 (last valid position, the
    token just written). Returns [B, H, D].

    A CUDA `q` launches kernel K1 (or raises); a CPU `q` — or
    FLAGS_use_paged_attention off — runs `paged_attention_plain`.
    `paged_attention.launches` counts kernel launches."""
    if q.is_cuda and flag("FLAGS_use_paged_attention"):
        monitor.stat_add("STAT_paged_attn_kernel")
        return _launch_paged_kernel(q, k_pages, v_pages, page_table, pos,
                                    scale)
    monitor.stat_add("STAT_paged_attn_reference")
    return paged_attention_plain(q, k_pages, v_pages, page_table, pos, scale)


paged_attention.launches = 0
