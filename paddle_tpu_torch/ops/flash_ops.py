"""Flash attention: the CUDA kernels, their plain versions, and autograd.

Counterpart of `paddle_tpu/ops/pallas_ops.py` (`flash_attention`,
`flash_attention_raw` and the three Pallas kernels behind it).

- `flash_attention(query, key, value, causal, scale, attn_mask,
  dropout_p, generator)`: the framework entry (`pallas_ops.py:498`). It
  turns a key-padding mask into the kernels' float32 [B, Sk] bias, draws
  the dropout seed, and applies `FlashAttention`.
- `FlashAttention`: the `torch.autograd.Function` (the JAX package's
  `custom_vjp`, `pallas_ops.py:421-439`). Forward: K2. Backward:
  `delta = rowsum(dO * O)` in torch, then K3 (dQ) and K4 (dK, dV).
- The kernel wrappers `flash_attention_fwd` (K2, `csrc/flash_fwd.cu`),
  `flash_attention_dq` (K3, `csrc/flash_bwd_dq.cu`) and
  `flash_attention_dkv` (K4, `csrc/flash_bwd_dkv.cu`): a CUDA `q`
  launches the hand-written kernel or raises; a CPU `q` runs the plain
  version (`_flash_fwd_reference`, `_dq_reference`, `_dkv_reference`).
  K2 is the registered op `paddle_tpu_torch::flash_fwd`
  (`torch.library.custom_op`: CPU implementation the plain version, CUDA
  implementation the kernel, a fake implementation for tracing), so the
  choice is the op's dispatch at run time: `torch.export` (`jit.save`)
  records the op, and a program saved on the CPU launches K2 on the
  card. Training reaches it through `FlashAttention.forward` too.
  Each wrapper's `.launches` counts its kernel launches (and
  `.launches_by_dtype` by operand type), and
  `STAT_flash_attention_fwd` / `_bwd` count them process-wide.
- Types: float32 (3xTF32), bfloat16 and float16 (mma.sync with fp32
  sums); `flash_supported(dtype=...)` and `_check` take the same three,
  as the JAX package's kernels take q's type (`pallas_ops.py:342`).
- Dropout: keep(i, j) <=> fmix32-chain hash of (seed, b*Hg + h0 + h, i,
  j) >= `_drop_thresh(p)`, over the GLOBAL head: a tensor-parallel rank
  that holds H of the model's Hg heads from head h0 (`head_shard`) keys
  its rows as tp 1 would, so the ranks of tp n draw tp 1's mask between
  them (Hg = H, h0 = 0 outside a shard). The seed word carries (h0, Hg)
  above its low 32 bits (`head_keyed_seed`), so autograd, the op's
  schema and the saved programs pass it as one int. The mask is keyed on
  absolute coordinates, so the forward and both backward kernels
  regenerate the same mask whatever their tiles, and `_keep_mask`
  reproduces it bit for bit. It is not the TPU kernel's mask (that one
  comes from the TPU PRNG, per tile).
- `flash_supported`: the static shape gate of the JAX package (head dims
  D % 8 == 0 up to 512), cut at the head dims the kernels are built for,
  every D % 8 == 0 up to 256 (`_head_dim_ok`, `csrc/flash_mma.cuh`
  "Head dims"). A shape the JAX gate takes only because its head dim lies
  in (256, 512] runs the plain path, and each such refusal counts in
  `STAT_attention_wide_head_fallback`.
- `_pick_blocks`: the JAX package's tile choice, kept for parity; the
  CUDA kernels use their own tiles of 64 rows (16, 32 or 64 streamed keys
  or queries in K2–K4, by head dim and type; see the sources). K2–K4 run
  on the
  tensor cores (fp32 as 3xTF32), so their fp32 results differ from the
  plain versions in the last bits; in bf16 K2 rounds P to bf16 before
  P V, as the TPU kernel does.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
from typing import Optional, Tuple

import torch

from .. import amp
from ..framework import monitor
from ..framework import random as frandom
from ..framework.errors import InvalidArgumentError
from ..framework.flags import flag
from . import _build
from ..framework.static_hook import named_op

__all__ = ["flash_attention", "FlashAttention", "flash_attention_fwd",
           "flash_attention_dq", "flash_attention_dkv", "flash_supported",
           "_flash_fwd_reference", "_flash_bwd_reference",
           "_keep_mask", "_pick_blocks", "head_shard", "head_keyed_seed"]

_BLOCK_MIN = 128        # alignment the gate requires of S_q / S_kv
_NEG_INF = -1e30
_KERNEL_TILE = 64       # the CUDA kernels' q and kv tile
_MAX_HEAD_DIM = 256     # K2-K7 are built for every D % 8 == 0 up to this
_REF_MAX_HEAD_DIM = 512  # the JAX package's gate (pallas_ops.py:482)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_M32 = 0xFFFFFFFF


def _pick_blocks(Sq, Sk, prefq=512, prefk=512):
    """Largest preferred tile (128/256/512, capped by the preferences)
    that divides each sequence length — the JAX package's TPU tile rule,
    whose 512/512 default came from a TPU sweep."""
    for s in (Sq, Sk):
        if s % _BLOCK_MIN != 0:
            raise ValueError(
                f"flash: sequence length {s} must be a multiple of "
                f"{_BLOCK_MIN} (pad the sequence or route through dense "
                f"attention via flash_supported)")
    bq = max(b for b in sorted({128, 256, 512, prefq})
             if Sq % b == 0 and b <= Sq and b <= prefq)
    bk = max(b for b in sorted({128, 256, 512, prefk})
             if Sk % b == 0 and b <= Sk and b <= prefk)
    return bq, bk


# -- the dropout keep mask ----------------------------------------------------

def _mul32(x, c):
    """(x * c) mod 2^32 for int64 tensors holding uint32 values, split in
    16-bit halves of c so no product leaves int64's range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x):
    """murmur3's 32-bit finalizer, as `flash::fmix32` (flash_common.cuh)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _drop_thresh(dropout_p):
    """The JAX threshold rule (pallas_ops.py:135-136): keep a position
    when its 32 random bits are >= this."""
    return min(int(dropout_p * 4294967296.0), _M32)


class _HeadShard(threading.local):
    span = None     # (first head, the model's heads) of this rank's heads


_head_shard = _HeadShard()


@contextlib.contextmanager
def head_shard(first, heads):
    """Within: the attention of this thread holds the model's heads
    [first, first + H) of `heads`, and its dropout draws those heads' rows
    of the whole model's mask (a tensor-parallel rank's attention)."""
    prev = _head_shard.span
    _head_shard.span = (int(first), int(heads))
    try:
        yield
    finally:
        _head_shard.span = prev


def head_keyed_seed(seed, first=None, heads=None):
    """The keep-mask seed of a call over heads [first, first + H) of
    `heads` (default: the thread's `head_shard`, else the call's own
    heads): the 32-bit seed with `first` in bits 32-47 and `heads` in bits
    48-62."""
    if first is None:
        if _head_shard.span is None:
            return int(seed) & _M32
        first, heads = _head_shard.span
    return (int(seed) & _M32) | (int(first) << 32) | (int(heads) << 48)


def _seed_heads(seed, H):
    """(32-bit seed, the model's heads, the first head) of a keyed seed."""
    s = int(seed)
    return s & _M32, ((s >> 48) & 0x7FFF) or H, (s >> 32) & 0xFFFF


def _keep_mask(seed, B, H, Sq, Sk, dropout_p, device):
    """bool [B, H, Sq, Sk]: the kernels' keep mask, bit for bit."""
    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)
    seed, hg, h0 = _seed_heads(seed, H)
    bh = (ar(B)[:, None] * hg + h0 + ar(H)[None, :]).reshape(-1)
    row = _fmix32(seed ^ _mul32(bh, 0x9E3779B1))
    row = _fmix32(row[:, None] ^ _mul32(ar(Sq), 0x85EBCA77)[None, :])
    bits = _fmix32(row[:, :, None] ^ _mul32(ar(Sk), 0xC2B2AE3D)[None, None])
    return (bits >= _drop_thresh(dropout_p)).reshape(B, H, Sq, Sk)


# -- plain versions -------------------------------------------------------------

def _masked_scores(q, k, bias, causal, scale):
    """float32 scores Q K^T * scale + bias, causal entries (top-left
    aligned) replaced by -1e30 — the expression the kernels compute."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    if causal:
        S, K = s.shape[-2], s.shape[-1]
        mask = torch.ones(S, K, dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, torch.full((), _NEG_INF, dtype=s.dtype,
                                            device=s.device))
    return s


def _flash_fwd_reference(q, k, v, bias, causal, scale, dropout_p=0.0,
                         seed=0):
    """The plain forward: softmax of the masked float32 scores, dropout on
    the probabilities (kept ones scaled by 1/(1-p)), float32 P V cast to
    q's type; and the row log-sum-exp [B*H, Sq] float32. Differentiable
    in q, k and v."""
    B, H, Sq, _ = q.shape
    s = _masked_scores(q, k, bias, causal, scale)
    lse = torch.logsumexp(s, dim=-1).reshape(B * H, Sq)
    p = torch.softmax(s, dim=-1)
    if dropout_p > 0.0:
        keep = _keep_mask(seed, B, H, Sq, k.shape[2], dropout_p, q.device)
        p = torch.where(keep, p / (1.0 - dropout_p), torch.zeros_like(p))
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return out, lse


def _delta(out, dout):
    """rowsum(dO * O) [B*H, Sq] float32, from the dropped O
    (pallas_ops.py:359-362)."""
    B, H, Sq, _ = out.shape
    return (dout.float() * out.float()).sum(-1).reshape(B * H, Sq)


def _bwd_terms(q, k, v, bias, dout, lse, delta, causal, scale, dropout_p,
               seed):
    """dS and the dropped P of the backward, recomputed from (q, k, lse)
    as the kernels do: P = exp(S - lse), dP = dO V^T masked and scaled,
    dS = P (dP - delta)."""
    B, H, Sq, _ = q.shape
    p = torch.exp(_masked_scores(q, k, bias, causal, scale)
                  - lse.reshape(B, H, Sq, 1))
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    pd = p
    if dropout_p > 0.0:
        keep = _keep_mask(seed, B, H, Sq, k.shape[2], dropout_p, q.device)
        zero = torch.zeros_like(p)
        dp = torch.where(keep, dp / (1.0 - dropout_p), zero)
        pd = torch.where(keep, p / (1.0 - dropout_p), zero)
    return p * (dp - delta.reshape(B, H, Sq, 1)), pd


def _dq_reference(q, k, v, bias, dout, lse, delta, causal, scale,
                  dropout_p=0.0, seed=0):
    """The plain dQ = scale * dS K, in q's type."""
    ds, _ = _bwd_terms(q, k, v, bias, dout, lse, delta, causal, scale,
                       dropout_p, seed)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
            ).to(q.dtype)


def _dkv_reference(q, k, v, bias, dout, lse, delta, causal, scale,
                   dropout_p=0.0, seed=0):
    """The plain dK = scale * dS^T Q and dV = Pd^T dO, in k's type."""
    ds, pd = _bwd_terms(q, k, v, bias, dout, lse, delta, causal, scale,
                        dropout_p, seed)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", pd, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_reference(q, k, v, bias, out, lse, dout, causal, scale,
                         dropout_p=0.0, seed=0):
    """The plain backward, written out as the kernels compute it (recompute
    P, dP, dS), not by autograd. Returns (dq, dk, dv)."""
    delta = _delta(out, dout)
    dq = _dq_reference(q, k, v, bias, dout, lse, delta, causal, scale,
                       dropout_p, seed)
    return (dq, *_dkv_reference(q, k, v, bias, dout, lse, delta, causal,
                                scale, dropout_p, seed))


# -- the shape gate ---------------------------------------------------------------

def _head_dim_ok(D):
    """A head dim K2-K7 are built for: D % 8 == 0, 0 < D <= 256."""
    return 0 < D <= _MAX_HEAD_DIM and D % 8 == 0


def _padded_width(D, is_float):
    """The width head dim D runs at in K2-K7 (`padded_width` of
    csrc/flash_mma.cuh): whole 8-chunk swizzle groups a row, a multiple
    of 64 above 128."""
    for w in (32, 64) + ((96,) if is_float else ()) + (128, 192, 256):
        if D <= w:
            return w
    raise ValueError(f"head dim {D} exceeds {_MAX_HEAD_DIM}")


def _gate_head_dim(D):
    """The head-dim part of the flash and splash gates: the JAX package's
    rule (D % 8 == 0, D <= 512) cut at the kernels' 256. A head dim of
    (256, 512], which the JAX package's kernels take, is refused and
    counted in STAT_attention_wide_head_fallback, so the plain path it
    falls to is visible."""
    if D % 8 != 0 or D > _REF_MAX_HEAD_DIM:
        return False
    if D > _MAX_HEAD_DIM:
        monitor.stat_add("STAT_attention_wide_head_fallback")
        return False
    return True


def flash_supported(q_shape, k_shape=None, v_shape=None, mask=None,
                    is_causal=False, min_seq=None, dtype=None):
    """Static gate: shapes the kernels handle. The JAX package's rules
    (4-D, matching B/H/D, causal only with Sq == Sk, sequence lengths
    multiples of 128, D % 8 == 0, Sq >= FLAGS_flash_attention_min_seq, a
    [B,1,1,Sk] key-padding mask at most), with head dims cut at the
    kernels' 256 (`_gate_head_dim`), and, when `dtype` is given (a torch
    dtype, or the set of q's, k's and v's), the types `_check` takes: one
    of float32, bfloat16, float16."""
    if dtype is not None:
        types = dtype if isinstance(dtype, (set, frozenset)) else {dtype}
        if len(types) != 1 or next(iter(types)) not in _DTYPES:
            return False
    if len(q_shape) != 4:
        return False
    B, H, Sq, D = q_shape
    k_shape = tuple(k_shape) if k_shape is not None else tuple(q_shape)
    v_shape = tuple(v_shape) if v_shape is not None else k_shape
    if len(k_shape) != 4 or k_shape != v_shape:
        return False
    Bk, Hk, Sk, Dk = k_shape
    if (Bk, Hk, Dk) != (B, H, D):
        return False
    if is_causal and Sk != Sq:
        return False
    if Sq % _BLOCK_MIN != 0 or Sk % _BLOCK_MIN != 0:
        return False
    if min_seq is None:
        min_seq = flag("FLAGS_flash_attention_min_seq")
    if Sq < min_seq:
        return False
    if mask is not None:
        ms = getattr(mask, "shape", None)
        if ms is None or len(ms) != 4 or ms[1] != 1 or ms[2] != 1 \
                or ms[0] != B or ms[3] != Sk:
            return False
    return _gate_head_dim(D)


# -- the kernels ---------------------------------------------------------------------

# source -> (C entry, its error-string function, number of pointer
# arguments, whether it keys dropout on the global head: (Hg, h0) after
# the seed)
_ENTRIES = {
    "flash_fwd.cu": ("flash_attention_forward",
                     "flash_attention_error_string", 6, True),
    "flash_bwd_dq.cu": ("flash_attention_bwd_dq",
                        "flash_bwd_dq_error_string", 8, True),
    "flash_bwd_dkv.cu": ("flash_attention_bwd_dkv",
                         "flash_bwd_dkv_error_string", 9, True),
}


def _launch(src, tensors, q, k, causal, scale, dropout_p, seed,
            entries=_ENTRIES):
    """Call the C entry of `src` (looked up in `entries`, which the splash
    kernels share this calling convention through) on `tensors`
    (pointers, None for no bias) on q's current stream; raise on a
    refused launch."""
    entry, err_name, n_ptr, keyed = entries[src]
    fn = _build.function(
        src, entry, [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_uint32, ctypes.c_float,
            ctypes.c_uint32] + [ctypes.c_int] * (2 * keyed)
        + [ctypes.c_void_p])
    B, H, Sq, D = q.shape
    thresh = _drop_thresh(dropout_p) if dropout_p > 0.0 else 0
    keep_scale = 1.0 / (1.0 - dropout_p) if dropout_p > 0.0 else 1.0
    seed, hg, h0 = _seed_heads(seed, H)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*[t.data_ptr() if t is not None else None for t in tensors],
                 B, H, Sq, k.shape[2], D, _DTYPES[q.dtype], int(bool(causal)),
                 float(scale), thresh, keep_scale, seed,
                 *((hg, h0) if keyed else ()), stream)
    if err:
        es = _build.function(src, err_name, [ctypes.c_int], ctypes.c_char_p)
        raise RuntimeError(f"{entry} launch failed: {es(err).decode()}")


def _check(q, k, v, bias, dtypes=_DTYPES, **rest):
    """What the kernels take: q/k/v (and the other [B,H,S,D] operands) of
    one type among `dtypes` (the flash kernels' float32, bfloat16 and
    float16 by default), a head dim D % 8 == 0 up to 256, sequence
    lengths multiples of 64, float32 [B, Sk] bias and [B*H, Sq]
    statistics, everything
    contiguous on q's device."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        names = "/".join(str(t).replace("torch.", "") for t in dtypes)
        raise InvalidArgumentError(
            f"these kernels take q/k/v of one type among {names}, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not _head_dim_ok(D) or Sq % _KERNEL_TILE or Sk % _KERNEL_TILE \
            or tuple(k.shape) != (B, H, Sk, D) or k.shape != v.shape:
        raise InvalidArgumentError(
            f"flash kernels: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} (head_dim D % 8 == 0, D <= {_MAX_HEAD_DIM}, "
            f"sequence lengths multiples of {_KERNEL_TILE})")
    if bias is not None and (tuple(bias.shape) != (B, Sk)
                             or bias.dtype != torch.float32):
        raise InvalidArgumentError(
            f"flash kernels: bias must be float32 [B, Sk], got "
            f"{tuple(bias.shape)} {bias.dtype}")
    for name, t in rest.items():
        if name in ("lse", "delta"):
            want, dt = (B * H, Sq), torch.float32
        else:
            want, dt = tuple(q.shape), q.dtype
        if tuple(t.shape) != want or t.dtype != dt:
            raise InvalidArgumentError(
                f"flash kernels: {name} must be {dt} {want}, got "
                f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias),
                    *rest.items()):
        if t is None:
            continue
        if t.device != q.device:
            raise InvalidArgumentError(
                f"flash kernels: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise InvalidArgumentError(
                f"flash kernels: {name} must be contiguous")


def flash_attention_fwd(q, k, v, bias=None, causal=False, scale=None,
                        dropout_p=0.0, seed=0):
    """Flash-attention forward. q [B,H,Sq,D], k/v [B,H,Sk,D]; bias an
    additive float32 key bias [B, Sk] or None; dropout on the
    probabilities with the keep mask of `seed`. Returns (out [B,H,Sq,D] in
    q's type, lse [B*H, Sq] float32).

    Calls the registered op `paddle_tpu_torch::flash_fwd`, whose dispatch
    picks the implementation from q's device when the call runs: a CUDA
    `q` launches kernel K2 (or raises), a CPU `q` runs the plain version.
    A program exported on the CPU (`jit.save`) therefore holds the op,
    not the plain math, and launches K2 once it runs on the card.
    `flash_attention_fwd.launches` counts kernel launches."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return torch.ops.paddle_tpu_torch.flash_fwd(
        q, k, v, bias, bool(causal), float(scale), float(dropout_p),
        int(seed))


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cpu")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], causal: bool, scale: float,
                  dropout_p: float, seed: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op's CPU implementation: the plain version."""
    return _flash_fwd_reference(q, k, v, bias, causal, scale, dropout_p,
                                seed)


@_flash_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, bias, causal, scale, dropout_p, seed):
    """The op's CUDA implementation: kernel K2 on q's current stream, or
    InvalidArgumentError for operands it does not take (never the plain
    version)."""
    _check(q, k, v, bias)
    B, H, Sq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B * H, Sq, dtype=torch.float32, device=q.device)
    _launch("flash_fwd.cu", (q, k, v, bias, out, lse), q, k, causal, scale,
            dropout_p, seed)
    _count(flash_attention_fwd, q.dtype)
    monitor.stat_add("STAT_flash_attention_fwd")
    return out, lse


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, bias, causal, scale, dropout_p, seed):
    """Shapes and types for tracing (`torch.export`): out like q,
    contiguous; lse [B*H, Sq] float32."""
    B, H, Sq, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((B * H, Sq), dtype=torch.float32))


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, bias, causal, scale, dropout_p, seed = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, bias, out, lse)
    ctx.args = (causal, scale, dropout_p, seed)


def _flash_fwd_backward(ctx, dout, dlse):
    """The op's gradient (a program holding the op, e.g. a Program loaded
    from its `.ptprog` document, differentiates through it): dQ by K3 and
    (dK, dV) by K4 through the same entries as `FlashAttention.backward`,
    their plain versions on CPU tensors. lse's cotangent is unused, as
    the JAX rule's."""
    q, k, v, bias, out, lse = ctx.saved_tensors
    dout = dout.contiguous()
    delta = _delta(out, dout)
    dq = flash_attention_dq(q, k, v, bias, dout, lse, delta, *ctx.args)
    dk, dv = flash_attention_dkv(q, k, v, bias, dout, lse, delta, *ctx.args)
    return dq, dk, dv, None, None, None, None, None


_flash_fwd_op.register_autograd(_flash_fwd_backward,
                                setup_context=_flash_fwd_setup)


def flash_attention_dq(q, k, v, bias, dout, lse, delta, causal, scale,
                       dropout_p=0.0, seed=0):
    """dQ of flash attention from the forward's `lse` and `delta =
    rowsum(dO * O)` ([B*H, Sq] float32 each). A CUDA `q` launches kernel
    K3 (or raises); a CPU `q` runs `_dq_reference`.
    `flash_attention_dq.launches` counts kernel launches."""
    if not q.is_cuda:
        return _dq_reference(q, k, v, bias, dout, lse, delta, causal, scale,
                             dropout_p, seed)
    _check(q, k, v, bias, dout=dout, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq.cu", (q, k, v, bias, dout, lse, delta, dq), q, k,
            causal, scale, dropout_p, seed)
    _count(flash_attention_dq, q.dtype)
    monitor.stat_add("STAT_flash_attention_bwd")
    return dq


def flash_attention_dkv(q, k, v, bias, dout, lse, delta, causal, scale,
                        dropout_p=0.0, seed=0):
    """(dK, dV) of flash attention, inputs as `flash_attention_dq`. A
    CUDA `q` launches kernel K4 (or raises); a CPU `q` runs
    `_dkv_reference`. `flash_attention_dkv.launches` counts kernel
    launches."""
    if not q.is_cuda:
        return _dkv_reference(q, k, v, bias, dout, lse, delta, causal, scale,
                              dropout_p, seed)
    _check(q, k, v, bias, dout=dout, lse=lse, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv.cu", (q, k, v, bias, dout, lse, delta, dk, dv),
            q, k, causal, scale, dropout_p, seed)
    _count(flash_attention_dkv, q.dtype)
    monitor.stat_add("STAT_flash_attention_bwd")
    return dk, dv


def _count(wrapper, dtype):
    """One kernel launch of `wrapper`, in `.launches` and in
    `.launches_by_dtype` under the operands' type ("bfloat16")."""
    wrapper.launches += 1
    wrapper.launches_by_dtype[str(dtype).replace("torch.", "")] += 1


for _w in (flash_attention_fwd, flash_attention_dq, flash_attention_dkv):
    _w.launches = 0
    _w.launches_by_dtype = collections.Counter()


# -- autograd and the framework entry ---------------------------------------------

class FlashAttention(torch.autograd.Function):
    """Flash attention with O(S·D) memory in forward and backward: the
    forward saves (q, k, v, bias, seed, out, lse) as `_flash_fwd_rule`
    does (pallas_ops.py:421); the backward recomputes P from (q, k, lse)
    and replays the same keep mask. bias and seed get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, causal, scale, dropout_p):
        out, lse = flash_attention_fwd(q, k, v, bias, causal, scale,
                                       dropout_p, seed)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (causal, scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = _delta(out, dout)
        dq = flash_attention_dq(q, k, v, bias, dout, lse, delta, *ctx.args)
        dk, dv = flash_attention_dkv(q, k, v, bias, dout, lse, delta,
                                     *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def _mask_to_bias(mask, B, Sk):
    """A [B,1,1,Sk] key-padding mask as the kernels' float32 [B, Sk]
    additive bias (boolean True = keep)."""
    m = mask.reshape(B, Sk)
    if m.dtype == torch.bool:
        return torch.where(m, torch.zeros((), device=m.device),
                           torch.full((), _NEG_INF, device=m.device))
    return m.float().contiguous()


@named_op
def flash_attention(query, key, value, causal=False, scale=None,
                    attn_mask=None, dropout_p=0.0, generator=None):
    """Framework-level entry, differentiable in query, key and value.

    attn_mask: None, or a [B, 1, 1, S_kv] additive (float) / boolean
    key-padding mask. With dropout, the int32 seed of the keep mask comes
    from `generator` when given, else from `framework.random.next_seed`
    for the query's device (as `pallas_ops.py:516-520` draws it), keyed
    on the thread's `head_shard` (`head_keyed_seed`). AMP's
    white op "flash_attention": under AMP float32 q/k/v are cast to the
    autocast type; the bias is not an argument of the op (it is closed
    over in the JAX package) and stays float32, as the kernels need."""
    query, key, value = amp.cast_args("flash_attention", query, key, value)
    if scale is None:
        scale = 1.0 / (query.shape[-1] ** 0.5)
    bias = None if attn_mask is None else _mask_to_bias(
        attn_mask, key.shape[0], key.shape[2])
    seed = _dropout_seed(query.device, dropout_p, generator)
    if dropout_p > 0.0:
        seed = head_keyed_seed(seed)
    return FlashAttention.apply(query.contiguous(), key.contiguous(),
                                value.contiguous(), bias, seed, bool(causal),
                                float(scale), float(dropout_p))


def _dropout_seed(device, dropout_p, generator):
    """The int32 seed of a keep mask: 0 without dropout, else drawn from
    `generator` when given, or from `device`'s stream in
    `framework.random`."""
    if dropout_p <= 0.0:
        return 0
    if generator is not None:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=generator.device).item())
    return frandom.next_seed(device)
