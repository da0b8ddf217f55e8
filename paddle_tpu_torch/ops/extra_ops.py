"""The fluid-era op library (port of `paddle_tpu.ops.extra_ops`;
reference `paddle/fluid/operators/`, each op's source named in its
docstring): layout ops (`pixel_unshuffle`, `channel_shuffle`,
`max_unpool2d`, `temporal_shift`, `affine_grid`, `space_to_depth`),
segment and tree ops, the CTR and sequence ops, ranking losses, RoI
pooling, and the distillation, detection and flow ops.

Plain PyTorch on the input's device, differentiable where the JAX
package's op is; no TPU kernel lies here. Each op goes through AMP's
cast by its op name (`_util.named`), as the JAX package's `apply_op`
does. Integer outputs keep the JAX package's types (int32).

Ops that draw (`shuffle_batch`, `nce`, `sample_logits`) draw when they
are called, as the JAX package draws at op-build time, from the port's
explicit generators: the host's stream of `framework.random` (seeded by
`paddle.seed`), or a generator of their own seeded with `seed`. The draw
is made on the host and copied to the input's device, so a call draws
the same on the card and on the CPU from the same state. Its bits are not
the JAX package's (another generator). `filter_by_instag` and
`var_conv_2d` read their LoD offsets on the host, as the JAX package
does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..framework import random as frandom
from ._util import idx, ints, named, tensor

__all__ = [
    "pixel_unshuffle", "channel_shuffle", "max_unpool2d", "temporal_shift",
    "affine_grid", "segment_sum", "segment_mean", "segment_max",
    "segment_min", "gather_tree", "affine_channel", "row_conv",
    "conv_shift", "cvm", "data_norm", "space_to_depth",
    "pad_constant_like", "partial_concat", "partial_sum", "l1_norm",
    "squared_l2_norm", "rank_loss", "bpr_loss", "center_loss",
    "hinge_loss", "im2sequence", "linear_chain_crf", "roi_pool",
    "shuffle_batch", "fsp", "cross_entropy2", "psroi_pool", "prroi_pool",
    "correlation", "nce", "deformable_conv", "batch_fc", "sample_logits",
    "filter_by_instag", "var_conv_2d", "tree_conv", "bilateral_slice",
    "rank_attention",
]

_I32 = torch.int32


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _draw_generator(seed):
    """The host generator a drawing op uses: its own for `seed`, else the
    port's stream for the CPU (`framework.random`)."""
    if seed is None:
        return frandom.generator("cpu")
    return torch.Generator().manual_seed(int(seed))


def _roi_batch(rois_num, R, device):
    """The image of each of R RoIs from the per-image counts, as
    `jnp.repeat(..., total_repeat_length=R)`: cut to R, or padded with the
    last image."""
    counts = idx(rois_num).to(device).reshape(-1)
    b = torch.repeat_interleave(torch.arange(counts.numel(), device=device),
                                counts)[:R]
    if b.numel() < R:
        last = b[-1:] if b.numel() else counts.new_zeros(1)
        b = torch.cat([b, last.expand(R - b.numel())])
    return b


# ---------------------------------------------------------------------------
# vision / layout
# ---------------------------------------------------------------------------

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


def space_to_depth(x, blocksize, name=None):
    """reference `space_to_depth_op.cc`: `pixel_unshuffle`'s layout."""
    return pixel_unshuffle(x, blocksize)


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
    k = _pair(kernel_size)
    s = k if stride is None else _pair(stride)
    p = _pair(padding)
    v, ind = named("unpool", x, indices)
    B, C, Hp, Wp = v.shape
    if output_size is not None:
        Ho, Wo = ints(output_size)[-2:]
    else:
        Ho = (Hp - 1) * s[0] + k[0] - 2 * p[0]
        Wo = (Wp - 1) * s[1] + k[1] - 2 * p[1]
    flat = torch.zeros(B, C, Ho * Wo, dtype=v.dtype, device=v.device)
    flat = flat.scatter_add(2, ind.reshape(B, C, -1).long(),
                            v.reshape(B, C, -1))
    return flat.reshape(B, C, Ho, Wo)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """reference `temporal_shift_op.h` (TSM): channels [0, c1) read frame
    t - 1, channels [c1, c2) read frame t + 1 (zeros past either end),
    the rest stay."""
    T = int(seg_num)
    (v,) = named("temporal_shift", x)
    if data_format == "NHWC":
        v = v.permute(0, 3, 1, 2)
    NT, C, H, W = v.shape
    c1 = int(C * shift_ratio)
    c2 = int(C * 2 * shift_ratio)
    v5 = v.reshape(NT // T, T, C, H, W)
    prev = torch.cat([torch.zeros_like(v5[:, :1, :c1]), v5[:, :-1, :c1]], 1)
    nxt = torch.cat([v5[:, 1:, c1:c2], torch.zeros_like(v5[:, :1, c1:c2])],
                    1)
    out = torch.cat([prev, nxt, v5[:, :, c2:]], 2).reshape(NT, C, H, W)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


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


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """reference `roi_pool_op.cc`: max over each of an RoI's quantized
    bins (bin i covers [floor(i h / oh), ceil((i + 1) h / oh)) from the
    RoI's rounded corner; an empty bin gives 0)."""
    oh, ow = _pair(output_size)
    feat, rois, num = named("roi_pool", x, boxes, boxes_num)
    N, C, H, W = feat.shape
    R = rois.shape[0]
    dev = feat.device
    b = _roi_batch(num, R, dev)
    r = torch.round(rois * spatial_scale).to(_I32)
    x1, y1, x2, y2 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    hh = torch.clamp(y2 - y1 + 1, min=1)[:, None]
    ww = torch.clamp(x2 - x1 + 1, min=1)[:, None]
    bh = torch.arange(oh, device=dev)[None]
    bw = torch.arange(ow, device=dev)[None]
    y_lo = y1[:, None] + torch.floor(bh * hh / oh).to(_I32)
    y_hi = y1[:, None] + torch.ceil((bh + 1) * hh / oh).to(_I32)
    x_lo = x1[:, None] + torch.floor(bw * ww / ow).to(_I32)
    x_hi = x1[:, None] + torch.ceil((bw + 1) * ww / ow).to(_I32)
    iy = torch.arange(H, device=dev)[None, None]
    ix = torch.arange(W, device=dev)[None, None]
    in_y = (iy >= y_lo.clamp(min=0)[..., None]) & \
        (iy < y_hi.clamp(max=H)[..., None])                # [R, oh, H]
    in_x = (ix >= x_lo.clamp(min=0)[..., None]) & \
        (ix < x_hi.clamp(max=W)[..., None])                # [R, ow, W]
    fmap = feat[b].float()                                 # [R, C, H, W]
    neg = torch.finfo(torch.float32).min
    rowmax = torch.where(in_y[:, :, None, :, None], fmap[:, None],
                         neg).amax(3)                      # [R, oh, C, W]
    sel = torch.where(in_x[:, None, :, None, :], rowmax[:, :, None],
                      neg).amax(4)                         # [R, oh, ow, C]
    empty = ~(in_y.any(2)[:, :, None] & in_x.any(2)[:, None, :])
    sel = torch.where(empty[..., None], 0.0, sel)
    return sel.permute(0, 3, 1, 2).to(feat.dtype)


# ---------------------------------------------------------------------------
# segment / tree ops
# ---------------------------------------------------------------------------

def _segment(kind):
    def op(data, segment_ids, num_segments=None, name=None):
        d, ids = named(f"segment_{kind}", data, segment_ids)
        ids = ids.long()
        if num_segments is None:
            # the count from the ids' values, as the JAX package derives
            # it from a concrete eager array
            num_segments = int(ids.max()) + 1 if ids.numel() else 0
        num = int(num_segments)
        shape = (num,) + tuple(d.shape[1:])
        # jax.ops.segment_*: ids outside [0, num) are dropped
        keep = (ids >= 0) & (ids < num)
        if not bool(keep.all()):
            d, ids = d[keep], ids[keep]
        if kind in ("sum", "mean"):
            s = d.new_zeros(shape).index_add(0, ids, d)
            if kind == "sum":
                return s
            cnt = d.new_zeros(num).index_add(0, ids, torch.ones_like(
                ids, dtype=d.dtype))
            return s / torch.clamp(cnt, min=1).reshape(
                (-1,) + (1,) * (d.dim() - 1))
        # an empty segment keeps the reduction's identity, as in JAX
        info = torch.finfo(d.dtype) if d.is_floating_point() else \
            torch.iinfo(d.dtype)
        fill = (-float("inf") if kind == "max" else float("inf")) \
            if d.is_floating_point() else (info.min if kind == "max"
                                           else info.max)
        index = ids.reshape((-1,) + (1,) * (d.dim() - 1)).expand_as(d)
        return d.new_full(shape, fill).scatter_reduce(
            0, index, d, "amax" if kind == "max" else "amin",
            include_self=False)
    op.__name__ = op.__qualname__ = f"segment_{kind}"
    op.__doc__ = (f"jax.ops.segment_{kind} over the leading axis: "
                  f"segment_ids [n] ints, num_segments from the ids when "
                  f"None.")
    return op


segment_sum = _segment("sum")
segment_mean = _segment("mean")
segment_max = _segment("max")
segment_min = _segment("min")


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


def tree_conv(nodes_vector, edge_set, filter, max_depth=1, name=None):
    """reference `tree_conv_op.cc` (TBCNN, depth-1 window): each node's
    top filter plus its children through the left / right filters
    weighted by their position among the parent's children; nodes_vector
    [B, N, D], edge_set [B, E, 2] (parent, child; (0, 0) pads), filter
    [D, H, 3]. Returns tanh(...) [B, N, H]."""
    x, edges, f = named("tree_conv", nodes_vector, edge_set, filter)
    B, N, D = x.shape
    wt, wl, wr = f[..., 0], f[..., 1], f[..., 2]
    par, chi = edges[..., 0].long(), edges[..., 1].long()
    valid = par != chi
    onehot = (torch.arange(N, device=x.device)[None, :, None]
              == par[:, None, :]) & valid[:, None, :]      # [B, N, E]
    n_child = onehot.sum(-1)
    hot = onehot.to(_I32)
    order = torch.cumsum(hot, -1) * hot                    # 1-based
    denom = torch.clamp(n_child[:, :, None] - 1, min=1)
    eta_r = (order - 1) / denom * hot
    eta_l = (1 - (order - 1) / denom) * hot
    child = torch.gather(x, 1, chi[:, :, None].expand(B, chi.shape[1], D))
    top = torch.einsum("bnd,dh->bnh", x, wt)
    left = torch.einsum("bne,bed,dh->bnh", eta_l.to(x.dtype), child, wl)
    right = torch.einsum("bne,bed,dh->bnh", eta_r.to(x.dtype), child, wr)
    return torch.tanh(top + left + right)


# ---------------------------------------------------------------------------
# fluid-era CTR / sequence ops
# ---------------------------------------------------------------------------

def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None):
    """reference `affine_channel_op.cc`: x * scale + bias a channel."""
    v, s, b = named("affine_channel", x, scale, bias)
    shape = ((1, -1, 1, 1) if data_layout == "NCHW" and v.dim() == 4
             else (1,) * (v.dim() - 1) + (-1,))
    return v * s.reshape(shape) + b.reshape(shape)


def row_conv(x, weight, name=None):
    """reference `row_conv_op.cc` (lookahead conv, streaming ASR):
    out[t] = sum_i x[t + i] * weight[i], x [B, T, D], weight [ctx, D]."""
    v, w = named("row_conv", x, weight)
    ctx = w.shape[0]
    B, T, D = v.shape
    pad = torch.cat([v, v.new_zeros(B, ctx - 1, D)], 1)
    out = torch.zeros_like(v)
    for i in range(ctx):
        out = out + pad[:, i:i + T, :] * w[i][None, None, :]
    return out


def conv_shift(x, y, name=None):
    """reference `conv_shift_op.cc`: a row's circular convolution, x
    [B, M], y [B, N] (N odd, N <= M)."""
    xv, yv = named("conv_shift", x, y)
    N = yv.shape[1]
    half = N // 2
    out = torch.zeros_like(xv)
    for j in range(N):
        out = out + torch.roll(xv, half - j, 1) * yv[:, j:j + 1]
    return out


def cvm(x, cvm_input, use_cvm=True, name=None):
    """reference `cvm_op.h` (CTR show / click): with use_cvm, X's first
    two columns become log(show + 1) and log(click + 1) - log(show + 1);
    without, they are dropped. `cvm_input` feeds only the reference's
    hand-written gradient; autograd here follows the forward."""
    v, _ = named("cvm", x, cvm_input)
    if use_cvm:
        col0 = torch.log(v[:, :1] + 1.0)
        col1 = torch.log(v[:, 1:2] + 1.0) - col0
        return torch.cat([col0, col1, v[:, 2:]], 1)
    return v[:, 2:]


def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4,
              name=None):
    """reference `data_norm_op.cc`: normalise by accumulated batch
    statistics (large CTR models)."""
    v, n, s, sq = named("data_norm", x, batch_size, batch_sum,
                        batch_square_sum)
    mean = s / n
    scale = torch.sqrt(n / torch.clamp(sq - n * mean * mean, min=epsilon))
    return (v - mean) * scale


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """reference `pad_constant_like_op.cc`: y padded at the end of each
    axis up to x's shape."""
    xv, yv = named("pad_constant_like", x, y)
    pads = []
    for i in range(yv.dim() - 1, -1, -1):
        pads += [0, xv.shape[i] - yv.shape[i]]
    return TF.pad(yv, pads, value=pad_value)


def partial_concat(xs, start_index=0, length=-1, name=None):
    """reference `partial_concat_op.cc`: the concat of one column slice of
    each input."""
    vals = named("partial_concat", *xs)
    stop = None if length < 0 else start_index + length
    return torch.cat([v[:, start_index:stop] for v in vals], 1)


def partial_sum(xs, start_index=0, length=-1, name=None):
    """reference `partial_sum_op.cc`: the sum of one column slice of each
    input."""
    vals = named("partial_sum", *xs)
    stop = None if length < 0 else start_index + length
    out = vals[0][:, start_index:stop]
    for v in vals[1:]:
        out = out + v[:, start_index:stop]
    return out


def l1_norm(x, name=None):
    """reference `l1_norm_op.cc`."""
    (v,) = named("l1_norm", x)
    return v.abs().sum()


def squared_l2_norm(x, name=None):
    """reference `squared_l2_norm_op.cc`."""
    (v,) = named("squared_l2_norm", x)
    return (v * v).sum()


def shuffle_batch(x, seed=None, name=None):
    """reference `shuffle_batch_op.cc`: the rows in a random order, the
    permutation drawn when called (module docstring)."""
    (v,) = named("shuffle_batch", x)
    perm = torch.randperm(int(v.shape[0]), generator=_draw_generator(seed))
    return torch.index_select(v, 0, perm.to(v.device))


# ---------------------------------------------------------------------------
# ranking / metric-learning losses
# ---------------------------------------------------------------------------

def rank_loss(label, left, right, name=None):
    """reference `rank_loss_op.cc` (RankNet): log(1 + e^o) - t o."""
    t, l, r = named("rank_loss", label, left, right)
    o = l - r
    return torch.logaddexp(torch.zeros_like(o), o) - t * o


def bpr_loss(logit, label, name=None):
    """reference `bpr_loss_op.cc` (Bayesian personalised ranking):
    -mean over j != pos of log sigmoid(logit_pos - logit_j), [B, 1]."""
    lv, yv = named("bpr_loss", logit, label)
    B, C = lv.shape
    y = yv.reshape(B, 1).long()
    pos = torch.gather(lv, 1, y)
    lsm = TF.logsigmoid(pos - lv)
    mask = torch.arange(C, device=lv.device)[None, :] != y
    return -(lsm * mask).sum(1, keepdim=True) / max(C - 1, 1)


def center_loss(x, label, centers, alpha=0.1, update_center=True,
                name=None):
    """reference `center_loss_op.cc`: 0.5 ||x - c_y||^2 a row; returns
    (loss [B, 1], the centers moved by alpha times each class's mean
    offset)."""
    xv, yv, cv = named("center_loss", x, label, centers)
    y = yv.reshape(-1).long()
    diff = xv - cv[y]
    loss = 0.5 * (diff * diff).sum(1, keepdim=True)
    if not update_center:
        return loss, cv
    num = cv.new_zeros(cv.shape[0]).index_add(0, y, torch.ones_like(
        y, dtype=cv.dtype))
    upd = torch.zeros_like(cv).index_add(0, y, diff)
    return loss, cv + alpha * upd / (1.0 + num)[:, None]


def hinge_loss(logits, labels, name=None):
    """reference `hinge_loss_op.cc`: max(0, 1 - (2 y - 1) logit)."""
    lv, yv = named("hinge_loss", logits, labels)
    return torch.clamp(1.0 - (2.0 * yv - 1.0) * lv, min=0.0)


# ---------------------------------------------------------------------------
# sequence ops
# ---------------------------------------------------------------------------

def im2sequence(x, filter_size=1, stride=1, padding=0, name=None):
    """reference `im2sequence_op.cc`: each sliding window a row,
    [B * oh * ow, C * kh * kw] (channel-major within a row)."""
    (v,) = named("im2sequence", x)
    cols = TF.unfold(v, _pair(filter_size), padding=_pair(padding),
                     stride=_pair(stride))             # [B, CK, L]
    return cols.transpose(1, 2).reshape(-1, cols.shape[1])


def linear_chain_crf(emission, transition, label, length, name=None):
    """reference `linear_chain_crf_op.cc`: a sequence's negative
    log-likelihood under a linear-chain CRF, in float32. emission
    [B, T, C]; transition [C + 2, C] (row 0 start, row 1 stop, then the
    pairs); label [B, T]; length [B]. Returns [B, 1]."""
    em, tr, yv, ln = named("linear_chain_crf", emission, transition, label,
                           length)
    em, tr = em.float(), tr.float()
    B, T, C = em.shape
    start, stop, trans = tr[0], tr[1], tr[2:]
    y = yv.long()
    ln = ln.long().reshape(-1)
    valid = torch.arange(T, device=em.device)[None, :] < ln[:, None]
    em_y = torch.gather(em, 2, y[:, :, None])[..., 0]
    score = (em_y * valid).sum(1) + start[y[:, 0]]
    pair = trans[y[:, :-1], y[:, 1:]]
    score = score + (pair * valid[:, 1:]).sum(1)
    last = torch.gather(y, 1, (ln - 1)[:, None])[:, 0]
    score = score + stop[last]
    alpha = start[None] + em[:, 0]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], 1) + em[:, t]
        alpha = torch.where(valid[:, t][:, None], nxt, alpha)
    logz = torch.logsumexp(alpha + stop[None], 1)
    return (logz - score)[:, None]


# ---------------------------------------------------------------------------
# distillation / detection / flow ops
# ---------------------------------------------------------------------------

def fsp(x, y, name=None):
    """reference `fsp_op.cc` (flow of solution procedure, distillation):
    [B, C1, H, W] x [B, C2, H, W] -> [B, C1, C2] / (H W)."""
    a, b = named("fsp", x, y)
    return torch.einsum("bchw,bdhw->bcd", a, b) / (a.shape[2] * a.shape[3])


def cross_entropy2(input, label, ignore_index=-100, name=None):
    """reference `cross_entropy_op.cc` (cross_entropy2): -log p[label] over
    post-softmax probabilities, 0 where the label is ignore_index."""
    p, y = named("cross_entropy2", input, label)
    yi = y.reshape(p.shape[0], 1)
    picked = torch.gather(p, -1, torch.clamp(yi, min=0).long())
    loss = -torch.log(torch.clamp(picked, min=1e-12))
    return torch.where(yi == ignore_index, 0.0, loss)


def psroi_pool(x, boxes, boxes_num, output_channels, spatial_scale,
               pooled_height, pooled_width, name=None):
    """reference `psroi_pool_op.cc` (R-FCN position-sensitive RoI
    pooling): C = output_channels * oh * ow, and bin (i, j) averages its
    own channel group over the pixels it covers."""
    oh, ow, oc = int(pooled_height), int(pooled_width), int(output_channels)
    feat, rois, num = named("psroi_pool", x, boxes, boxes_num)
    N, C, H, W = feat.shape
    R = rois.shape[0]
    dev = feat.device
    b = _roi_batch(num, R, dev)
    r = rois * spatial_scale
    x1, y1 = r[:, 0, None], r[:, 1, None]
    hh = torch.clamp(r[:, 3] - r[:, 1], min=0.1)[:, None]
    ww = torch.clamp(r[:, 2] - r[:, 0], min=0.1)[:, None]
    iy = torch.arange(H, device=dev, dtype=torch.float32)
    ix = torch.arange(W, device=dev, dtype=torch.float32)
    grp = feat[b].float().reshape(R, oc, oh, ow, H, W)
    rows = []
    for i in range(oh):
        ylo, yhi = y1 + i * hh / oh, y1 + (i + 1) * hh / oh
        my = (iy >= torch.floor(ylo)) & (iy < torch.ceil(yhi))   # [R, H]
        row = []
        for j in range(ow):
            xlo, xhi = x1 + j * ww / ow, x1 + (j + 1) * ww / ow
            mx = (ix >= torch.floor(xlo)) & (ix < torch.ceil(xhi))
            m = my[:, :, None] & mx[:, None, :]                  # [R, H, W]
            cnt = torch.clamp(m.sum((1, 2)), min=1)
            row.append((grp[:, :, i, j] * m[:, None]).sum((2, 3))
                       / cnt[:, None])
        rows.append(torch.stack(row, -1))                        # [R, oc, ow]
    return torch.stack(rows, -2).to(feat.dtype)                  # [R,oc,oh,ow]


def prroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """reference `prroi_pool_op.cc` (precise RoI pooling), as the JAX
    package computes it: `vision.ops.roi_align` at 4 samples a bin, not
    aligned."""
    from ..vision.ops import roi_align
    return roi_align(x, boxes, boxes_num, output_size, spatial_scale,
                     sampling_ratio=4, aligned=False)


def correlation(x1, x2, pad_size, kernel_size, max_displacement,
                stride1=1, stride2=1, corr_type_multiply=1, name=None):
    """reference `correlation_op.cc` (FlowNet's cost volume, kernel 1 and
    strides 1): the channel mean of x1 times x2 shifted by each of the
    (2 d + 1)^2 displacements, 0 where the shift wrapped."""
    d = int(max_displacement)
    a, b = named("correlation", x1, x2)
    B, C, H, W = a.shape
    maps = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            shifted = torch.roll(b, (dy, dx), (2, 3))
            valid = torch.zeros(H, W, dtype=torch.bool, device=a.device)
            valid[max(0, dy):H + min(0, dy), max(0, dx):W + min(0, dx)] = \
                True
            maps.append(torch.where(valid[None], (a * shifted).mean(1),
                                    0.0))
    return torch.stack(maps, 1)


def nce(input, label, num_total_classes, nid_weight=None, bias=None,
        num_neg_samples=10, sampler="uniform", seed=None, name=None,
        param_attr=None, bias_attr=None):
    """reference `nce_op.cc` (noise-contrastive estimation): a logistic
    loss over the positive class and `num_neg_samples` uniform negatives
    a row, [B, 1]. Weights [C, D] and bias [C] are made when not given
    (a named `param_attr` / `bias_attr` shares them across calls, as
    fluid's LayerHelper does); the negatives are drawn when called
    (module docstring)."""
    from ..static.nn import shared_parameter
    D = int(input.shape[-1])
    C = int(num_total_classes)
    w = nid_weight if nid_weight is not None else \
        shared_parameter([C, D], "float32", attr=param_attr)
    b = bias if bias is not None else \
        shared_parameter([C], "float32", attr=bias_attr, is_bias=True)
    xv, yv, wv, bv = named("nce", input, label, w, b)
    neg = torch.randint(0, C, (int(xv.shape[0]), int(num_neg_samples)),
                        generator=_draw_generator(seed)).to(xv.device)
    y = yv.reshape(-1).long()
    pos_s = (xv * wv[y]).sum(-1) + bv[y]
    neg_s = torch.einsum("bd,bsd->bs", xv, wv[neg]) + bv[neg]
    loss = -TF.logsigmoid(pos_s) - TF.logsigmoid(-neg_s).sum(-1)
    return loss[:, None]


def _bilinear(img, yy, xx):
    """img [B, C, H, W] at float rows / columns yy, xx [B, Ho, Wo]:
    [B, C, Ho, Wo], zeros outside the map."""
    B, C, H, W = img.shape
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy, wx = yy - y0, xx - x0
    flat = img.reshape(B, C, H * W)
    out = 0.0
    for oy, wy_ in ((0, 1 - wy), (1, wy)):
        for ox, wx_ in ((0, 1 - wx), (1, wx)):
            yi = (y0 + oy).to(torch.int64)
            xi = (x0 + ox).to(torch.int64)
            ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            at = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, 1,
                                                                      -1)
            v = torch.gather(flat, 2, at.expand(B, C, at.shape[2]))
            v = v.reshape(B, C, *yy.shape[1:])
            out = out + torch.where(ok[:, None], v, 0.0) * (wy_ * wx_)[:, None]
    return out


def deformable_conv(x, offset, weight, mask=None, stride=1, padding=0,
                    dilation=1, deformable_groups=1, groups=1,
                    im2col_step=1, name=None):
    """reference `deformable_conv_op.cc` (v2; v1 without `mask`): the
    input sampled bilinearly at each kernel tap's offset position (offset
    [B, 2 kh kw, Ho, Wo] as (dy, dx) pairs), times the mask, then
    contracted with the kernel."""
    if deformable_groups != 1 or groups != 1:
        raise NotImplementedError("deformable_conv: deformable_groups/"
                                  "groups > 1")
    s, p, dl = _pair(stride), _pair(padding), _pair(dilation)
    args = named("deformable_conv", x, offset, weight,
                 *(() if mask is None else (mask,)))
    xv, ov, wv = args[:3]
    B, C, H, W = xv.shape
    O, _, kh, kw = wv.shape
    Ho = (H + 2 * p[0] - dl[0] * (kh - 1) - 1) // s[0] + 1
    Wo = (W + 2 * p[1] - dl[1] * (kw - 1) - 1) // s[1] + 1
    base_y = (torch.arange(Ho, device=xv.device) * s[0] - p[0])[:, None]
    base_x = (torch.arange(Wo, device=xv.device) * s[1] - p[1])[None, :]
    cols = []
    for ki in range(kh):
        for kj in range(kw):
            k = ki * kw + kj
            yy = base_y + ki * dl[0] + ov[:, 2 * k, :Ho, :Wo]
            xx = base_x + kj * dl[1] + ov[:, 2 * k + 1, :Ho, :Wo]
            samp = _bilinear(xv, yy, xx)                  # [B, C, Ho, Wo]
            if len(args) > 3:
                samp = samp * args[3][:, k][:, None, :Ho, :Wo]
            cols.append(samp)
    col = torch.stack(cols, 2)                            # [B, C, K, Ho, Wo]
    return torch.einsum("bckhw,ock->bohw", col, wv.reshape(O, C, kh * kw))


def batch_fc(input, w, bias=None, name=None):
    """reference `batch_fc_op.cc` (CTR, one FC a slot): [S, B, in] x
    [S, in, out] (+ bias [S, out]) -> [S, B, out]."""
    args = named("batch_fc", input, w, *(() if bias is None else (bias,)))
    out = torch.einsum("sbi,sio->sbo", args[0], args[1])
    return out + args[2][:, None, :] if len(args) > 2 else out


def sample_logits(logits, label, num_samples, seed=None, name=None):
    """reference `sample_logits_op.cc` (sampled softmax): the true label's
    logit and `num_samples` uniform negatives a row, drawn when called
    (module docstring). Returns (logits [B, 1 + S], ids [B, 1 + S] int32),
    column 0 the positive."""
    lg, yv = named("sample_logits", logits, label)
    B, C = int(lg.shape[0]), int(lg.shape[-1])
    neg = torch.randint(0, C, (B, int(num_samples)),
                        generator=_draw_generator(seed)).to(lg.device)
    ids = torch.cat([yv.reshape(B, 1).to(_I32), neg.to(_I32)], 1)
    return torch.gather(lg, 1, ids.long()), ids


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True, name=None):
    """reference `filter_by_instag_op.cc` (CTR): the rows of `ins` whose
    tag list (a LoDTensor of per-instance tags, or one tag a row) meets
    `filter_tag`. Returns (rows, kept row indices int32, loss weights
    [kept, 1]); with nothing kept, one zero row and weight 0."""
    from .legacy import LoDTensor, _host, _seq_offsets
    dev = ins.device if torch.is_tensor(ins) else None
    tags = _host(ins_tag).reshape(-1).astype(int)
    offs = _seq_offsets(ins_tag) if isinstance(ins_tag, LoDTensor) \
        else list(range(len(tags) + 1))
    want = set(_host(filter_tag).reshape(-1).astype(int).tolist())
    keep = [i for i, (a, b) in enumerate(zip(offs[:-1], offs[1:]))
            if want & set(tags[a:b].tolist())]
    v = tensor(ins, dev)
    if keep:
        k = torch.tensor(keep, dtype=torch.int64, device=v.device)
        rows = v[k]
        lw = torch.ones(len(keep), 1, dtype=torch.float32, device=v.device)
    else:
        rows = v.new_zeros((1,) + tuple(v.shape[1:]))
        lw = torch.zeros(1, 1, dtype=torch.float32, device=v.device)
    return rows, torch.tensor(keep, dtype=_I32, device=v.device), lw


def var_conv_2d(input, row, col, input_channel, output_channel,
                filter_size, stride=1, w=None, name=None):
    """reference `var_conv_2d_op.cc`: a LoD batch of images of their own
    sizes (image i is `input`'s i-th sequence, [C_in, row_i, col_i]
    flattened), each convolved with w [C_out, C_in, k, k] (made when
    None) at padding k // 2. Returns a LoDTensor of the flattened
    outputs; the images loop on the host, as in the JAX package."""
    from ..nn import functional as F
    from .legacy import LoDTensor, _host, _seq_offsets, create_parameter
    k = filter_size if isinstance(filter_size, int) else filter_size[0]
    s = stride if isinstance(stride, int) else stride[0]
    if w is None:
        w = create_parameter([output_channel, input_channel, k, k],
                             "float32")
    offs = _seq_offsets(input)
    v = input.reshape(-1)
    rows = _host(row).reshape(-1).astype(int)
    cols = _host(col).reshape(-1).astype(int)
    outs, new_offs = [], [0]
    for i, (a, b) in enumerate(zip(offs[:-1], offs[1:])):
        img = v[a:b].reshape(1, input_channel, rows[i], cols[i])
        o = F.conv2d(img, w, stride=s,
                     padding=k // 2).reshape(-1)
        outs.append(o)
        new_offs.append(new_offs[-1] + o.numel())
    return LoDTensor(torch.cat(outs), [new_offs])


def bilateral_slice(x, guide, grid, has_offset=True, name=None):
    """reference `bilateral_slice_op.cc` (HDRNet): each pixel's affine
    coefficients sliced from the bilateral grid at (x, y, guide) by
    trilinear interpolation, then applied to its channels. x
    [N, Ci, H, W]; guide [N, H, W] in [0, 1]; grid [N, Co (Ci + 1), Gd,
    Gh, Gw] with the offset, [N, Co Ci, ...] without. [N, Co, H, W]."""
    xv, gv, grid_v = named("bilateral_slice", x, guide, grid)
    N, Ci, H, W = xv.shape
    _, CC, Gd, Gh, Gw = grid_v.shape
    cols = Ci + 1 if has_offset else Ci
    if CC % cols != 0:
        raise ValueError(
            f"bilateral_slice: grid channels {CC} not divisible by "
            f"{cols} (= input channels{' + offset' if has_offset else ''})"
            " — check has_offset / grid layout")
    Co = CC // cols
    dev = xv.device
    gx = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) * Gw / W \
        - 0.5
    gy = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) * Gh / H \
        - 0.5
    gxb, gyb = gx[None, :].expand(H, W), gy[:, None].expand(H, W)
    gz = torch.clamp(gv.float(), 0.0, 1.0) * Gd - 0.5      # [N, H, W]
    x0, y0, z0 = torch.floor(gxb), torch.floor(gyb), torch.floor(gz)
    wx, wy, wz = gxb - x0, gyb - y0, gz - z0
    g = grid_v.float().reshape(N, CC, Gd * Gh * Gw)
    coef = 0.0
    for dz, wz_ in ((0, 1 - wz), (1, wz)):
        zi = torch.clamp(z0 + dz, 0, Gd - 1).long()
        for dy, wy_ in ((0, 1 - wy), (1, wy)):
            yi = torch.clamp(y0 + dy, 0, Gh - 1).long()
            for dx, wx_ in ((0, 1 - wx), (1, wx)):
                xi = torch.clamp(x0 + dx, 0, Gw - 1).long()
                at = ((zi * Gh + yi) * Gw + xi).reshape(N, 1, H * W)
                corner = torch.gather(g, 2, at.expand(N, CC, H * W))
                coef = coef + corner.reshape(N, CC, H, W) \
                    * (wz_ * wy_ * wx_)[:, None]
    coef = coef.reshape(N, Co, cols, H, W)
    out = torch.einsum("nochw,nchw->nohw", coef[:, :, :Ci], xv.float())
    if has_offset:
        out = out + coef[:, :, Ci]
    return out.to(xv.dtype)


def rank_attention(input, rank_offset, rank_param, max_rank=3,
                   param_attr=None, name=None):
    """reference `rank_attention_op.cc` + `rank_attention.cu.h` (CTR
    rank-feature attention): X [ins, D]; RankOffset [ins, 2 max_rank + 1]
    (column 0 the instance's 1-based rank, 0 absent, then (rank, row)
    pairs of up to max_rank related instances); RankParam
    [max_rank^2 D, para_col], a [D, para_col] block a (rank, rank) pair
    (made when given as a shape). Out[i] = sum_k X[row_k] @ block(my
    rank, rank_k), absent pairs adding nothing."""
    if isinstance(rank_param, (tuple, list)):
        from ..static.nn import shared_parameter
        rank_param = shared_parameter(list(rank_param), "float32",
                                      attr=param_attr)
    # the reference's InferShape checks: a wrong shape would read another
    # parameter block silently
    off_cols = int(rank_offset.shape[1])
    if off_cols != 2 * max_rank + 1:
        raise ValueError(
            f"rank_attention: RankOffset has {off_cols} columns, "
            f"expected 2*max_rank+1 = {2 * max_rank + 1}")
    D_in = int(input.shape[1])
    p_rows = int(rank_param.shape[0])
    if p_rows != max_rank * max_rank * D_in:
        raise ValueError(
            f"rank_attention: RankParam has {p_rows} rows, expected "
            f"max_rank^2 * input_dim = {max_rank * max_rank * D_in}")
    x, off, p = named("rank_attention", input, rank_offset, rank_param)
    ins, D = x.shape
    off = off.long()
    my = off[:, 0] - 1
    ranks = off[:, 1::2] - 1
    rows = off[:, 2::2]
    valid = (my[:, None] >= 0) & (ranks >= 0)
    help_in = torch.where(valid[..., None], x[rows.clamp(0, ins - 1)], 0.0)
    start = torch.clamp(my[:, None] * max_rank + ranks, 0,
                        max_rank * max_rank - 1)
    pb = p.reshape(max_rank * max_rank, D, p.shape[1])
    help_p = torch.where(valid[..., None, None], pb[start], 0.0)
    return torch.einsum("ikd,ikdp->ip", help_in, help_p)

