"""Scaled-dot-product attention with the flash-kernel fast path.

Port of `paddle_tpu.nn.functional.attention.scaled_dot_product_attention`
without `segment_ids` (sequence packing comes with a later slice).

Dispatch: a query that passes `flash_supported` with
FLAGS_use_flash_attention on goes through `ops.flash_ops.flash_attention`
— with or without dropout, with or without grad. That is a
`torch.autograd.Function` whose forward is kernel K2 and whose backward is
K3 + K4 on a CUDA tensor, and their plain versions on a CPU tensor (as
the JAX package runs its Pallas kernels in interpret mode off the TPU).
Everything else runs `_sdpa_ref`, the JAX package's fallback math
exactly: bottom-right causal alignment when S < K (the KV-cache decode
shape), -1e30 masking, and dropout on the probabilities (upscale-in-
train), not on the output.
"""
from __future__ import annotations

import torch

from ...framework.flags import flag
from ...ops.flash_ops import flash_attention, flash_supported

__all__ = ["scaled_dot_product_attention"]

_NEG = -1e30


def _sdpa_ref(q, k, v, mask, scale, is_causal, dropout_p=0.0,
              generator=None):
    # q,k,v: [B, H, S, D]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    neg = torch.full((), _NEG, dtype=s.dtype, device=s.device)
    if is_causal:
        S, K = s.shape[-2], s.shape[-1]
        # bottom-right aligned: query i sits at absolute position K-S+i
        qpos = torch.arange(S, device=s.device)[:, None] + (K - S)
        allowed = qpos >= torch.arange(K, device=s.device)[None, :]
        s = torch.where(allowed[None, None], s, neg)
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
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None, scale=None):
    """query/key/value: [batch, num_heads, seq, head_dim] (BHSD).

    attn_mask: None, a boolean mask (True = attend) or an additive float
    mask broadcastable to [B, H, Sq, Sk]; only the [B,1,1,Sk] key-padding
    shape can take the flash kernels. `generator` drives dropout (on the
    flash path it draws the keep mask's seed); `scale` defaults to
    1/sqrt(head_dim)."""
    if scale is None:
        scale = 1.0 / (query.shape[-1] ** 0.5)
    eff_dropout = dropout_p if training else 0.0
    if flag("FLAGS_use_flash_attention") and flash_supported(
            tuple(query.shape), tuple(key.shape), tuple(value.shape),
            attn_mask, is_causal=is_causal):
        return flash_attention(query, key, value, causal=is_causal,
                               scale=scale, attn_mask=attn_mask,
                               dropout_p=eff_dropout, generator=generator)
    return _sdpa_ref(query, key, value, attn_mask, scale, is_causal,
                     eff_dropout, generator)
