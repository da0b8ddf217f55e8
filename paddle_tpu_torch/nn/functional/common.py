"""Common functionals (port of `paddle_tpu.nn.functional.common`;
reference `python/paddle/nn/functional/common.py`, `input.py`): `linear`,
the dropouts, `embedding`, `one_hot`, `label_smooth`, `pad`,
`interpolate` / `upsample`, the distances, `pixel_shuffle`, `unfold` /
`fold`, `bilinear`, `normalize`, `sequence_mask` and `grid_sample`.

`linear` is AMP's white op "linear"; the others are in no list and run
in the type that reaches them, unless a custom list of `auto_cast` names
them (every op is cast by its JAX name, as `apply_op` does there).

`interpolate` reproduces the JAX package's `jax.image.resize`, not
`torch.nn.functional.interpolate` (ROADMAP C20): separable weight
matrices applied with `einsum`, half-pixel centres, `align_corners` and
`align_mode` ignored, an antialiasing kernel when the linear and cubic
modes downsample, "area" as linear, and the Keys cubic kernel with
a = -0.5."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ... import amp
from ...framework.dtype import canonical_dtype
from ...ops._util import named
from ...ops.linalg import promoted
from ...ops.manipulation import pad  # noqa: F401  (re-exported)
from ...framework.static_hook import named_op

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "pad", "interpolate",
           "upsample", "cosine_similarity", "pixel_shuffle", "unfold",
           "bilinear", "pairwise_distance", "normalize", "sequence_mask",
           "fold", "grid_sample"]


@named_op
def linear(x, weight, bias=None, name=None):
    """x @ weight + bias with the JAX package's weight layout
    [in_features, out_features] (`nn.Linear` keeps PyTorch's [out, in]
    and passes its transpose, a view). Under AMP the float32 operands
    are cast to the autocast type. The bias is added inside the GEMM's
    epilogue (`torch.nn.functional.linear`), so a bfloat16 product is
    rounded once; the JAX package rounds `x @ W` and then adds the bias
    in bfloat16."""
    args = (x, weight) if bias is None else (x, weight, bias)
    x, w, *b = promoted(*amp.cast_args("linear", *args))
    return TF.linear(x, w.t(), b[0] if b else None)


@named_op
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability p (one draw per position of
    the axes in `axis` when given, shared along the others). Mode
    "upscale_in_train" scales the kept ones by 1 / (1 - p);
    "downscale_in_infer" keeps them as they are. Out of training, or at
    p 0, `x` itself, as in the JAX package. Draws from torch's default
    generator of x's device."""
    if not training or p == 0.0:
        return x
    (x,) = amp.cast_args("dropout", x)
    if axis is None and mode == "upscale_in_train":
        return TF.dropout(x, p, True)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = torch.rand(shape, device=x.device) >= p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, 0.0).to(x.dtype)


@named_op
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` [num_embeddings, dim] at the integer ids `x`; a
    position whose id is `padding_idx` gives zeros (and no gradient), as
    in the JAX package. `sparse` is accepted and unused."""
    x, weight = amp.cast_args("embedding", x, weight)
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Drop whole channels: one draw per (sample, channel)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


@named_op
def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: a dropped element takes the negative
    saturation value, then an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    (x,) = named("alpha_dropout", x)
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    mask = torch.rand(x.shape, device=x.device) >= p
    return (a * torch.where(mask, x, alpha_p) + b).to(x.dtype)


@named_op
def one_hot(x, num_classes, name=None):
    """float32 [..., num_classes]; an id outside [0, num_classes) gives a
    row of zeros (the JAX package's `jax.nn.one_hot`, where
    `torch.nn.functional.one_hot` raises)."""
    (x,) = named("one_hot", x)
    classes = torch.arange(int(num_classes), device=x.device)
    return (x[..., None] == classes).to(torch.float32)


@named_op
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) * label + epsilon * prior (uniform over the last
    axis when no `prior_dist`)."""
    if prior_dist is not None:
        v, pr = named("label_smooth", label, prior_dist)
        return (1 - epsilon) * v + epsilon * pr
    (v,) = named("label_smooth", label)
    return (1 - epsilon) * v + epsilon / v.shape[-1]


# -- interpolate: jax.image.resize's separable weights -----------------------

def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.)
    out = np.where(x >= 1., ((np.float32(-0.5) * x + np.float32(2.5)) * x
                             - np.float32(4.)) * x + np.float32(2.), out)
    return np.where(x >= 2., np.float32(0.), out).astype(np.float32)


def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _resize_weights(m, n, kernel):
    """[m, n] float32: output j = sum_i in_i w[i, j] along one axis of
    size m resized to n — `jax/_src/image/scale.py` `compute_weight_mat`
    with scale n / m, translation 0 and antialiasing, in float32."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n / m))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = kernel(x.astype(f32))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000. * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= f32(m) - f32(0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def _nearest_index(m, n):
    """jax.image.resize's nearest rows: floor((j + 0.5) * m / n) in
    float32 (half-pixel centres)."""
    f32 = np.float32
    off = (np.arange(n, dtype=f32) + f32(0.5)) * f32(m) / f32(n)
    return np.floor(off).astype(np.int64)


@named_op
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes to `size` (or int(size * scale_factor)) as
    the JAX package's `jax.image.resize` does (module docstring): modes
    nearest, linear / bilinear / trilinear / area (all linear) and
    bicubic. `align_corners` and `align_mode` are taken and unused, as
    there."""
    (v,) = named("interpolate", x)
    chan_last = data_format in ("NHWC", "NWC", "NDHWC")
    spat = list(v.shape[1:-1] if chan_last else v.shape[2:])
    if size is not None:
        tgt = [int(s.item() if torch.is_tensor(s) else s)
               for s in (size if isinstance(size, (list, tuple))
                         else [size])]
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * len(spat))
        tgt = [int(d * f) for d, f in zip(spat, sf)]
    kernel = {"nearest": None, "bilinear": _triangle, "trilinear": _triangle,
              "linear": _triangle, "area": _triangle,
              "bicubic": _keys_cubic}[mode]
    first = 1 if chan_last else 2
    if kernel is not None and not v.is_floating_point():
        v = v.float()
    letters = "abcdefgh"[:v.dim()]
    for i, (m, n) in enumerate(zip(spat, tgt)):
        if m == n:
            continue
        d = first + i
        if kernel is None:
            v = torch.index_select(v, d, torch.from_numpy(
                _nearest_index(m, n)).to(v.device))
            continue
        w = torch.from_numpy(_resize_weights(m, n, kernel)).to(
            device=v.device, dtype=v.dtype)
        out = letters[:d] + "z" + letters[d + 1:]
        v = torch.einsum(f"{letters},{letters[d]}z->{out}", v, w)
    return v


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


@named_op
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    a, b = named("cosine_similarity", x1, x2)
    num = torch.sum(a * b, dim=axis)
    d1 = torch.sqrt(torch.sum(a * a, dim=axis))
    d2 = torch.sqrt(torch.sum(b * b, dim=axis))
    return num / torch.clamp(d1 * d2, min=eps)


@named_op
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    a, b = named("pairwise_distance", x, y)
    d = a - b + epsilon
    return torch.sum(torch.abs(d) ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)


@named_op
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    (v,) = named("normalize", x)
    nrm = torch.sum(torch.abs(v) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return v / torch.clamp(nrm, min=epsilon)


@named_op
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = int(upscale_factor)
    (v,) = named("pixel_shuffle", x)
    if data_format == "NCHW":
        n, c, h, w = v.shape
        v = v.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return v.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = v.shape
    v = v.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h * r, w * r, c // (r * r))


def _to2(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads4(paddings):
    """unfold / fold paddings as (top, bottom, left, right); a 4-list is
    the reference's [top, left, bottom, right]."""
    if isinstance(paddings, int):
        return (paddings,) * 4
    if len(paddings) == 2:
        return (paddings[0], paddings[0], paddings[1], paddings[1])
    return (paddings[0], paddings[2], paddings[1], paddings[3])


@named_op
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C, H, W] -> [N, C * kh * kw, L], channels major."""
    (v,) = named("unfold", x)
    pt, pb, pl, pr = _pads4(paddings)
    v = TF.pad(v, (pl, pr, pt, pb))
    return TF.unfold(v, _to2(kernel_sizes), dilation=_to2(dilations),
                     stride=_to2(strides))


@named_op
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of `unfold`: [N, C * kh * kw, L] ->
    [N, C, H, W]; overlapping positions sum."""
    (v,) = named("fold", x)
    H, W = _to2(output_sizes)
    pt, pb, pl, pr = _pads4(paddings)
    out = TF.fold(v, (H + pt + pb, W + pl + pr), _to2(kernel_sizes),
                  dilation=_to2(dilations), stride=_to2(strides))
    return out[:, :, pt:pt + H, pl:pl + W]


@named_op
def bilinear(x1, x2, weight, bias=None, name=None):
    """out[b, o] = x1[b] W[o] x2[b] (+ bias), weight [out, in1, in2]."""
    args = (x1, x2, weight) + ((bias,) if bias is not None else ())
    a, b, w, *rest = named("bilinear", *args)
    out = torch.einsum("bi,oij,bj->bo", a, w, b)
    return out + rest[0] if rest else out


@named_op
def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """[..., maxlen] mask of positions below each length, in `dtype`
    narrowed as jnp narrows it (int64 -> int32). With `maxlen` None the
    length is read on the host and the type is int64 narrowed, whatever
    `dtype` says, as in the JAX package."""
    (lens,) = named("sequence_mask", lengths)
    if maxlen is None:
        m, dt = int(lens.max()), canonical_dtype("int64")
    else:
        m, dt = int(maxlen), canonical_dtype(dtype)
    rng = torch.arange(m, device=lens.device)
    return (rng < lens[..., None]).to(dt)


def _grid_coord(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(c, lo, hi):
    rng = hi - lo
    c2 = torch.abs(torch.remainder(c - lo, 2.0 * rng))
    return lo + torch.where(c2 > rng, 2.0 * rng - c2, c2)


@named_op
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample x [N, C, H, W] at grid [N, Hg, Wg, 2] of (x, y) in [-1, 1]:
    the JAX package's gather and lerp (nearest rounds half to even),
    differentiable in x and grid."""
    v, g = named("grid_sample", x, grid)
    N, C, H, W = v.shape
    ix = _grid_coord(g[..., 0], W, align_corners)
    iy = _grid_coord(g[..., 1], H, align_corners)
    if padding_mode == "reflection":
        if align_corners:
            ix, iy = _reflect(ix, 0.0, W - 1.0), _reflect(iy, 0.0, H - 1.0)
        else:
            ix, iy = _reflect(ix, -0.5, W - 0.5), _reflect(iy, -0.5, H - 0.5)
    if padding_mode in ("border", "reflection"):
        ix = torch.clamp(ix, 0.0, W - 1.0)
        iy = torch.clamp(iy, 0.0, H - 1.0)
    b = torch.arange(N, device=v.device)[:, None, None]

    def gather(yi, xi):
        got = v[b, :, torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        if padding_mode == "zeros":
            ok = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
            got = got * ok[..., None].to(got.dtype)
        return got                                   # [N, Hg, Wg, C]

    if mode == "nearest":
        out = gather(torch.round(iy).long(), torch.round(ix).long())
        return torch.movedim(out, -1, 1)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx, wy = (ix - x0)[..., None], (iy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    top = gather(y0i, x0i) * (1 - wx) + gather(y0i, x0i + 1) * wx
    bot = gather(y0i + 1, x0i) * (1 - wx) + gather(y0i + 1, x0i + 1) * wx
    return torch.movedim(top * (1 - wy) + bot * wy, -1, 1)
