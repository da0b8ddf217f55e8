"""Scaled-dot-product attention with the flash and splash fast paths.

Port of `paddle_tpu.nn.functional.attention.scaled_dot_product_attention`,
with its positional contract `(query, key, value, attn_mask, dropout_p,
is_causal, training, name, segment_ids)`; `generator` and `scale`, which
the port adds, are keyword-only.

Dispatch without `segment_ids`: a query that passes `flash_supported`
with FLAGS_use_flash_attention on goes through
`ops.flash_ops.flash_attention` — with or without dropout, with or
without grad. That is a `torch.autograd.Function` whose forward is kernel
K2 and whose backward is K3 + K4 on a CUDA tensor, and their plain
versions on a CPU tensor (as the JAX package runs its Pallas kernels in
interpret mode off the TPU).

With `segment_ids` (packed rows): splash attention
(`ops.splash_ops.splash_attention`, kernels K5-K7 or their plain
versions) when FLAGS_use_splash_attention is on and `splash_supported`
passes, counted in STAT_splash_dispatches; else the dense fallback with
the same segment-within-causal mask, so packed batches are always
correct and only the work differs.

AMP, as in the JAX package: the flash entry casts as the white op
"flash_attention" (its key-padding bias stays float32), the plain
branch as the white op "sdpa" (a float mask too); the splash
("splash_attention") and the dense segment-masked ("sdpa_segment")
branches are in no list, so their q/k/v run in the type the projections
gave them.

Everything else runs `_sdpa_ref`, the JAX package's fallback math
exactly: bottom-right causal alignment when S < K (the KV-cache decode
shape), -1e30 masking, dropout on the probabilities (upscale-in-train),
not on the output, and, with segment ids, zero output for a row with no
visible key.
"""
from __future__ import annotations

import torch

from ... import amp
from ...framework import monitor
from ...framework.flags import flag
from ...ops.flash_ops import flash_attention, flash_supported
from ...ops.splash_ops import _ids, splash_attention, splash_supported

__all__ = ["scaled_dot_product_attention"]

_NEG = -1e30


def _sdpa_ref(q, k, v, mask, scale, is_causal, dropout_p=0.0,
              generator=None, seg=None):
    # q,k,v: [B, H, S, D]; seg: (q_seg [B,S], kv_seg [B,K]) packed-row
    # segment ids, cross-segment pairs masked as the splash kernels do
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    # -1e30 in s's type, by conversion: -inf in float16, as the JAX
    # package's jnp.where(..., s, -1e30) gives (a row with no visible key
    # is then NaN in float16 there too)
    neg = torch.full((), _NEG, device=s.device).to(s.dtype)
    allowed = None
    if is_causal:
        S, K = s.shape[-2], s.shape[-1]
        # bottom-right aligned: query i sits at absolute position K-S+i
        qpos = torch.arange(S, device=s.device)[:, None] + (K - S)
        allowed = (qpos >= torch.arange(K, device=s.device)[None, :])[
            None, None]
    if seg is not None:
        q_seg, kv_seg = seg
        same = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        allowed = same if allowed is None else allowed & same
    if allowed is not None:
        s = torch.where(allowed, s, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            s = torch.where(mask, s, neg)
        else:
            s = s + mask
    p = torch.softmax(s, dim=-1)
    if dropout_p > 0.0:
        keep = torch.rand(p.shape, generator=generator, device=p.device,
                          dtype=p.dtype) >= dropout_p
        p = torch.where(keep, p / (1.0 - dropout_p), torch.zeros_like(p))
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    if seg is not None:
        # a row with no visible key outputs zeros (the splash kernels'
        # rule), not the uniform mix a -1e30 softmax gives
        out = torch.where(allowed.any(-1, keepdim=True), out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def _norm_segment_ids(segment_ids):
    """segment_ids: a [B, S] tensor/array shared by q and kv, or a
    (q_seg, kv_seg) pair. Returns the pair."""
    if isinstance(segment_ids, (tuple, list)):
        q_seg, kv_seg = segment_ids
        return q_seg, kv_seg
    return segment_ids, segment_ids


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None,
                                 segment_ids=None, *, generator=None,
                                 scale=None):
    """query/key/value: [batch, num_heads, seq, head_dim] (BHSD).

    attn_mask: None, a boolean mask (True = attend) or an additive float
    mask broadcastable to [B, H, Sq, Sk]; only the [B,1,1,Sk] key-padding
    shape can take the flash kernels. `name` is accepted and unused, as
    in the reference. segment_ids: packed-row segment ids, a [B, S] int
    tensor/array shared by q and kv or a (q_seg, kv_seg) pair,
    non-decreasing along each row (the `io.PackingCollator` layout):
    tokens attend only within their segment (and causally when
    is_causal). Mutually exclusive with attn_mask. `generator` drives
    dropout (on the kernel paths it draws the keep mask's seed); `scale`
    defaults to 1/sqrt(head_dim)."""
    if scale is None:
        scale = 1.0 / (query.shape[-1] ** 0.5)
    eff_dropout = dropout_p if training else 0.0
    if segment_ids is not None:
        if attn_mask is not None:
            raise ValueError(
                "scaled_dot_product_attention: attn_mask and segment_ids "
                "are mutually exclusive — packed padding is expressed as "
                "a trailing pad segment, not a key-padding mask")
        q_seg, kv_seg = _norm_segment_ids(segment_ids)
        if flag("FLAGS_use_splash_attention") and splash_supported(
                tuple(query.shape), tuple(key.shape), tuple(value.shape),
                is_causal=is_causal):
            monitor.stat_add("STAT_splash_dispatches")
            return splash_attention(query, key, value, q_seg, kv_seg,
                                    causal=is_causal, scale=scale,
                                    dropout_p=eff_dropout,
                                    generator=generator)
        query, key, value = amp.cast_args("sdpa_segment", query, key,
                                          value)
        return _sdpa_ref(query, key, value, None, scale, is_causal,
                         eff_dropout, generator,
                         seg=(_ids(q_seg, query.device),
                              _ids(kv_seg, query.device)))
    if flag("FLAGS_use_flash_attention"):
        # the gate sees the types flash_attention's AMP cast will give
        fq, fk, fv = amp.cast_args("flash_attention", query, key, value)
        if flash_supported(tuple(fq.shape), tuple(fk.shape),
                           tuple(fv.shape), attn_mask, is_causal=is_causal,
                           dtype={fq.dtype, fk.dtype, fv.dtype}):
            return flash_attention(fq, fk, fv, causal=is_causal,
                                   scale=scale, attn_mask=attn_mask,
                                   dropout_p=eff_dropout,
                                   generator=generator)
    if attn_mask is None:
        query, key, value = amp.cast_args("sdpa", query, key, value)
    else:
        query, key, value, attn_mask = amp.cast_args(
            "sdpa", query, key, value, attn_mask)
    return _sdpa_ref(query, key, value, attn_mask, scale, is_causal,
                     eff_dropout, generator)
