"""Flash-attention forward: the CUDA kernel and its plain version.

Counterpart of `paddle_tpu/ops/pallas_ops.py`, forward only, without
dropout (dropout inside the kernel, and the backward kernels, come with
the training slice).

- `flash_attention_fwd(q, k, v, bias, causal, scale) -> (out, lse)`: a
  CUDA `q` launches the hand-written kernel `csrc/flash_fwd.cu` (K2) or
  raises; a CPU `q` runs `_sdpa_reference` and the row log-sum-exp.
- `flash_supported`: the static shape gate of the JAX package, plus the
  head dims the kernel is built for.
- `_pick_blocks`: the JAX package's tile choice, kept for parity; the
  CUDA kernel uses its own fixed 64x64 tiles (see the source).
"""
from __future__ import annotations

import ctypes

import torch

from ..framework.errors import InvalidArgumentError
from ..framework.flags import flag
from . import _build

__all__ = ["flash_attention_fwd", "flash_supported", "_sdpa_reference",
           "_pick_blocks"]

_BLOCK_MIN = 128        # alignment the gate requires of S_q / S_kv
_NEG_INF = -1e30
_KERNEL_TILE = 64       # the CUDA kernel's q and kv tile
_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _masked_scores(q, k, bias, causal, scale):
    """float32 scores Q K^T * scale + bias, causal entries (top-left
    aligned) replaced by -1e30 — the expression the kernel computes."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    if causal:
        S, K = s.shape[-2], s.shape[-1]
        mask = torch.ones(S, K, dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, torch.full((), _NEG_INF, dtype=s.dtype,
                                            device=s.device))
    return s


def _sdpa_reference(q, k, v, bias, causal, scale):
    """The plain version: softmax of the masked float32 scores, float32
    P V, cast to q's type."""
    p = torch.softmax(_masked_scores(q, k, bias, causal, scale), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _lse_reference(q, k, bias, causal, scale):
    """Row log-sum-exp of the masked scores, [B*H, Sq] float32 — the
    statistic the kernel emits (m + log l)."""
    B, H, Sq, _ = q.shape
    return torch.logsumexp(_masked_scores(q, k, bias, causal, scale),
                           dim=-1).reshape(B * H, Sq)


def flash_supported(q_shape, k_shape=None, v_shape=None, mask=None,
                    is_causal=False, min_seq=None):
    """Static gate: shapes the kernel handles. The JAX package's rules
    (4-D, matching B/H/D, causal only with Sq == Sk, sequence lengths
    multiples of 128, Sq >= FLAGS_flash_attention_min_seq, a [B,1,1,Sk]
    key-padding mask at most) plus this kernel's head dims (32/64/128)."""
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
    if Sq % _BLOCK_MIN != 0 or Sk % _BLOCK_MIN != 0 or D not in _HEAD_DIMS:
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
    return True


def _launch_flash_kernel(q, k, v, bias, causal, scale):
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise InvalidArgumentError(
            f"flash kernel takes float32 or bfloat16 q/k/v of one type, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in _HEAD_DIMS or Sq % _KERNEL_TILE or Sk % _KERNEL_TILE \
            or tuple(k.shape) != (B, H, Sk, D) or k.shape != v.shape:
        raise InvalidArgumentError(
            f"flash kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} (head_dim in {_HEAD_DIMS}, sequence lengths "
            f"multiples of {_KERNEL_TILE})")
    if bias is not None:
        if tuple(bias.shape) != (B, Sk) or bias.dtype != torch.float32:
            raise InvalidArgumentError(
                f"flash kernel: bias must be float32 [B, Sk], got "
                f"{tuple(bias.shape)} {bias.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t is None:
            continue
        if t.device != q.device:
            raise InvalidArgumentError(
                f"flash kernel: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise InvalidArgumentError(
                f"flash kernel: {name} must be contiguous")
    lib = _build.load("flash_fwd.cu")
    fn = lib.flash_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    out = torch.empty_like(q)
    lse = torch.empty(B * H, Sq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D,
                 _DTYPES[q.dtype], int(bool(causal)), float(scale), stream)
    if err:
        raise RuntimeError(
            "flash kernel launch failed: "
            + lib.flash_attention_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, bias=None, causal=False, scale=None):
    """Flash-attention forward. q [B,H,Sq,D], k/v [B,H,Sk,D]; bias an
    additive float32 key bias [B, Sk] or None. Returns (out [B,H,Sq,D]
    in q's type, lse [B*H, Sq] float32).

    A CUDA `q` launches kernel K2 (or raises); a CPU `q` runs the plain
    version. `flash_attention_fwd.launches` counts kernel launches."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.is_cuda:
        return _launch_flash_kernel(q, k, v, bias, causal, scale)
    return (_sdpa_reference(q, k, v, bias, causal, scale),
            _lse_reference(q, k, bias, causal, scale))


flash_attention_fwd.launches = 0
