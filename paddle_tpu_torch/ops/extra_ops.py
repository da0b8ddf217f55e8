"""The ops of `paddle_tpu.ops.extra_ops` that `nn.functional` re-exports
(port of `extra_ops.py:36-270` there; reference `paddle/fluid/operators/
{pixel_shuffle,shuffle_channel,unpool,affine_grid,gather_tree}_op.*`):
`pixel_unshuffle`, `channel_shuffle`, `max_unpool2d`, `affine_grid` and
`gather_tree`. Plain PyTorch on the input's device; no TPU kernel lies
here. `temporal_shift` and the rest of the module wait for ROADMAP A8."""
from __future__ import annotations

import torch

from ._util import ints, named

__all__ = ["pixel_unshuffle", "channel_shuffle", "max_unpool2d",
           "affine_grid", "gather_tree"]


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """The inverse of `pixel_shuffle` (space to depth)."""
    r = int(downscale_factor)
    (v,) = named("pixel_unshuffle", x)
    if data_format == "NHWC":
        v = v.permute(0, 3, 1, 2)
    B, C, H, W = v.shape
    v = v.reshape(B, C, H // r, r, W // r, r).permute(0, 1, 3, 5, 2, 4)
    v = v.reshape(B, C * r * r, H // r, W // r)
    return v.permute(0, 2, 3, 1) if data_format == "NHWC" else v


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """ShuffleNet's channel shuffle over `groups` groups."""
    g = int(groups)
    (v,) = named("channel_shuffle", x)
    if data_format == "NHWC":
        v = v.permute(0, 3, 1, 2)
    B, C, H, W = v.shape
    v = v.reshape(B, g, C // g, H, W).transpose(1, 2).reshape(B, C, H, W)
    return v.permute(0, 2, 3, 1) if data_format == "NHWC" else v


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    """Scatter-add pooled values back to the flat positions `indices`
    (per sample and channel) of an [Ho, Wo] map."""
    k = (kernel_size,) * 2 if isinstance(kernel_size, int) else kernel_size
    s = k if stride is None else stride
    s = (s,) * 2 if isinstance(s, int) else s
    p = (padding,) * 2 if isinstance(padding, int) else padding
    v, idx = named("unpool", x, indices)
    B, C, Hp, Wp = v.shape
    if output_size is not None:
        Ho, Wo = ints(output_size)[-2:]
    else:
        Ho = (Hp - 1) * s[0] + k[0] - 2 * p[0]
        Wo = (Wp - 1) * s[1] + k[1] - 2 * p[1]
    flat = torch.zeros(B, C, Ho * Wo, dtype=v.dtype, device=v.device)
    flat = flat.scatter_add(2, idx.reshape(B, C, -1).long(),
                            v.reshape(B, C, -1))
    return flat.reshape(B, C, Ho, Wo)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The 2-D sampling grid [N, H, W, 2] of affine matrices theta
    [N, 2, 3] (pairs with `F.grid_sample`); the product in float32."""
    N, C, H, W = ints(out_shape)
    (th,) = named("affine_grid", theta)

    def axis(n):
        if align_corners:
            return torch.linspace(-1.0, 1.0, n, device=th.device)
        step = 2.0 / n
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, n,
                              device=th.device)
    gy, gx = torch.meshgrid(axis(H), axis(W), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # [H, W, 3]
    return torch.einsum("hwk,nak->nhwa", base, th.float()).to(th.dtype)


def gather_tree(ids, parents, name=None):
    """Whole beams from beam search's per-step tokens and parent beams,
    ids / parents [T, B, beam]: from the last step back, each beam
    follows its parent pointers; out[t, b, w] is the token at step t of
    the sequence that ends in beam w."""
    idv, parv = named("gather_tree", ids, parents)
    T, B, W = idv.shape
    path = torch.arange(W, device=idv.device).expand(B, W)
    outs = []
    for t in range(T - 1, -1, -1):
        outs.append(torch.gather(idv[t], 1, path))
        path = torch.gather(parv[t].long(), 1, path)
    return torch.stack(outs[::-1])
