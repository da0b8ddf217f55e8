"""Vision and detection ops (port of `paddle_tpu.vision.ops`; reference
`python/paddle/vision/ops.py` and `paddle/fluid/operators/detection/`):
`box_iou`, `nms`, `roi_align`, `roi_pool`, `yolo_box`, `box_coder`,
`distribute_fpn_proposals`, `yolov3_loss`, `anchor_generator`,
`prior_box`, `generate_proposals` and `multiclass_nms`.

Plain PyTorch on the input's device; no TPU kernel lies here (the JAX
package reaches no `pallas_call` from this file). `box_iou`, `roi_align`,
`yolo_box`, `box_coder` and `yolov3_loss` are differentiable tensor code.
`anchor_generator` and `prior_box` compute their constants in numpy, as
the JAX package does, and put them on the input's device.

The NMS family (`nms`, `multiclass_nms`, `generate_proposals`) keeps the
JAX package's greedy scan, which that package runs on the host in numpy
by design; here the sort, the boxes' decoding and each class's IoU
matrix are computed on the input's device, the matrix compared with the
threshold there and copied to the host packed eight pairs a byte, and
only the scan itself (one pass over a class's candidates by falling
score) runs on the host. The IoU is the JAX package's formula, op for op
in float32, so the same boxes keep the same candidates. Their results
come back on the input's device. The reference sorts with numpy's
quicksort, which orders equal scores arbitrarily; the port's sort is
stable, so the two agree wherever no two scores tie.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ..ops._util import idx, named, tensor
from ..ops.extra_ops import _roi_batch

__all__ = ["nms", "roi_align", "roi_pool", "yolo_box", "yolov3_loss",
           "anchor_generator", "prior_box", "generate_proposals",
           "multiclass_nms", "box_coder",
           "box_iou", "distribute_fpn_proposals"]

# the IoU matrices of one pass of the scan stay under this many elements
_IOU_CHUNK = 1 << 26


def box_iou(boxes1, boxes2):
    """The [N, M] IoU of xyxy boxes."""
    a, b = named("box_iou", boxes1, boxes2)
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter + 1e-10)


def _iou_matrix(b, offset):
    """[G, K, K] IoU of each group's boxes b [G, K, 4] with each other,
    by the JAX package's NMS formula and order of operations."""
    x1, y1, x2, y2 = b.unbind(-1)
    w = torch.clamp(torch.minimum(x2[:, :, None], x2[:, None, :])
                    - torch.maximum(x1[:, :, None], x1[:, None, :])
                    + offset, min=0)
    h = torch.clamp(torch.minimum(y2[:, :, None], y2[:, None, :])
                    - torch.maximum(y1[:, :, None], y1[:, None, :])
                    + offset, min=0)
    inter = w * h
    area = (x2 - x1 + offset) * (y2 - y1 + offset)
    return inter / (area[:, :, None] + area[:, None, :] - inter + 1e-10)


def _packed_suppression(iou, thr):
    """not (iou <= thr) a pair, as numpy bools [G, K, K] from a copy of
    one bit a pair."""
    G, K, _ = iou.shape
    sup = ~(iou <= thr)
    pad = (-K) % 8
    if pad:
        sup = TF.pad(sup, (0, pad))
    bits = sup.reshape(G, K, -1, 8).to(torch.uint8) * torch.tensor(
        [1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8, device=iou.device)
    packed = bits.sum(-1, dtype=torch.uint8).cpu().numpy()
    return np.unpackbits(packed, axis=-1, bitorder="little")[..., :K] \
        .astype(bool)


def _greedy_groups(boxes, counts, thr, offset, eta):
    """The greedy scan of each group: boxes [G, K, 4] by falling score,
    the first counts[g] of group g real. Returns a list of numpy arrays
    of the kept positions, in the order kept. With eta < 1 the threshold
    falls by eta after each kept box while it is above 0.5 (the
    reference's adaptive NMS), so the IoU itself goes to the host."""
    G, K = boxes.shape[:2]
    out = []
    step = max(1, _IOU_CHUNK // max(K * K, 1))
    for g0 in range(0, G, step):
        iou = _iou_matrix(boxes[g0:g0 + step], offset)
        if eta < 1.0:
            rows = iou.cpu().numpy()
        else:
            rows = _packed_suppression(iou, float(thr))
        for g in range(rows.shape[0]):
            n = int(counts[g0 + g])
            removed = np.zeros(n, bool)
            keep = []
            t = float(thr)
            for i in range(n):
                if removed[i]:
                    continue
                keep.append(i)
                if eta < 1.0:
                    removed |= ~(rows[g, i, :n] <= t)
                    if t > 0.5:
                        t *= eta
                else:
                    removed |= rows[g, i, :n]
            out.append(np.asarray(keep, np.int64))
    return out


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, offset=0.0, eta=1.0):
    """Greedy NMS (reference `operators/detection/nms_op` /
    multiclass_nms), per category when `category_idxs` is given: the
    kept indices (int32, on the boxes' device) by falling score. offset
    1.0 is the unnormalised pixel convention (w = x2 - x1 + 1); eta < 1
    lowers the threshold after each kept box while it is above 0.5."""
    b = tensor(boxes)
    dev = b.device
    n = b.shape[0]
    s = (tensor(scores, dev).float() if scores is not None else
         torch.arange(n - 1, -1, -1, device=dev).float())
    cat = (idx(category_idxs).to(dev).reshape(-1)
           if category_idxs is not None
           else torch.zeros(n, dtype=torch.int64, device=dev))
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    classes = torch.unique(cat, sorted=True)
    members = [torch.nonzero(cat == c).reshape(-1) for c in classes]
    counts = [int(m.numel()) for m in members]
    K = max(counts)
    order = torch.zeros(len(members), K, dtype=torch.int64, device=dev)
    for g, m in enumerate(members):
        so = torch.sort(s[m], descending=True, stable=True).indices
        order[g, :m.numel()] = m[so]
    kept = _greedy_groups(b.float()[order], counts, iou_threshold, offset,
                          eta)
    order_h = _host(order)
    keep_all = np.concatenate([order_h[g, k] for g, k in enumerate(kept)])
    s_h = _host(s)
    keep_all = keep_all[np.argsort(-s_h[keep_all], kind="stable")]
    if top_k is not None:
        keep_all = keep_all[:top_k]
    return torch.from_numpy(keep_all.astype(np.int32)).to(dev)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign (reference `operators/roi_align_op`): each bin the mean of
    sampling_ratio^2 bilinear samples (2^2 when not positive), samples
    clamped into the map."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else output_size
    sr = sampling_ratio if sampling_ratio > 0 else 2
    feat, rois, num = named("roi_align", x, boxes, boxes_num)
    N, C, H, W = feat.shape
    R = rois.shape[0]
    dev = feat.device
    b = _roi_batch(num, R, dev)
    off = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * spatial_scale - off
    y1 = rois[:, 1] * spatial_scale - off
    x2 = rois[:, 2] * spatial_scale - off
    y2 = rois[:, 3] * spatial_scale - off
    bw = torch.clamp(x2 - x1, min=1e-6)
    bh = torch.clamp(y2 - y1, min=1e-6)
    ys = y1[:, None] + (torch.arange(oh * sr, device=dev) + 0.5)[None, :] \
        * bh[:, None] / (oh * sr)
    xs = x1[:, None] + (torch.arange(ow * sr, device=dev) + 0.5)[None, :] \
        * bw[:, None] / (ow * sr)
    yy = torch.clamp(ys, 0, H - 1)
    xx = torch.clamp(xs, 0, W - 1)
    y0 = torch.floor(yy).to(torch.int64)
    x0 = torch.floor(xx).to(torch.int64)
    y1_ = torch.clamp(y0 + 1, max=H - 1)
    x1_ = torch.clamp(x0 + 1, max=W - 1)
    wy = (yy - y0)[:, None, :, None]
    wx = (xx - x0)[:, None, None, :]
    f = feat[b]                                            # [R, C, H, W]

    def gat(yi, xi):
        rows = torch.gather(f, 2, yi[:, None, :, None].expand(
            R, C, yi.shape[1], W))
        return torch.gather(rows, 3, xi[:, None, None, :].expand(
            R, C, yi.shape[1], xi.shape[1]))
    v = (gat(y0, x0) * (1 - wy) * (1 - wx) + gat(y1_, x0) * wy * (1 - wx)
         + gat(y0, x1_) * (1 - wy) * wx + gat(y1_, x1_) * wy * wx)
    return v.reshape(R, C, oh, sr, ow, sr).mean((3, 5))


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """reference `operators/roi_pool_op.cc`: max over quantized bins
    (`ops.extra_ops.roi_pool`)."""
    from ..ops.extra_ops import roi_pool as _impl
    return _impl(x, boxes, boxes_num, output_size, spatial_scale)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0, name=None):
    """reference `operators/detection/yolo_box_op`: a head's raw output
    [N, na (5 + classes), H, W] decoded into xyxy boxes in image pixels
    [N, na H W, 4] and class scores (sigmoid x objectness) [N, na H W,
    classes], a box's scores zero where its best is under conf_thresh."""
    na = len(anchors) // 2
    feat, imgs = named("yolo_box", x, img_size)
    anc = torch.tensor(np.asarray(anchors, np.float32).reshape(na, 2),
                       device=feat.device)
    N, C, H, W = feat.shape
    feat = feat.reshape(N, na, 5 + class_num, H, W)
    gx = torch.arange(W, dtype=torch.float32, device=feat.device)
    gy = torch.arange(H, dtype=torch.float32, device=feat.device)
    sx = torch.sigmoid(feat[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
    sy = torch.sigmoid(feat[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
    bx = (gx[None, None, None, :] + sx) / W
    by = (gy[None, None, :, None] + sy) / H
    bw = torch.exp(feat[:, :, 2]) * anc[None, :, 0, None, None] / \
        (W * downsample_ratio)
    bh = torch.exp(feat[:, :, 3]) * anc[None, :, 1, None, None] / \
        (H * downsample_ratio)
    conf = torch.sigmoid(feat[:, :, 4])
    probs = torch.sigmoid(feat[:, :, 5:]) * conf[:, :, None]
    imw = imgs[:, 1].float()[:, None, None, None]
    imh = imgs[:, 0].float()[:, None, None, None]
    x1 = (bx - bw / 2) * imw
    y1 = (by - bh / 2) * imh
    x2 = (bx + bw / 2) * imw
    y2 = (by + bh / 2) * imh
    if clip_bbox:
        x1 = torch.minimum(torch.clamp(x1, min=0), imw - 1)
        y1 = torch.minimum(torch.clamp(y1, min=0), imh - 1)
        x2 = torch.minimum(torch.clamp(x2, min=0), imw - 1)
        y2 = torch.minimum(torch.clamp(y2, min=0), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1).reshape(N, -1, 4)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(N, -1, class_num)
    mask = scores.amax(-1) >= conf_thresh
    return boxes, torch.where(mask[..., None], scores, 0.0)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """reference `operators/detection/box_coder_op`: decode centre-size
    deltas on priors ("decode_center_size"), or encode target boxes
    against them."""
    prior, var, tgt = named("box_coder", prior_box, prior_box_var,
                            target_box)
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    if code_type == "decode_center_size":
        tx, ty, tw, th = tgt.unbind(-1)
        cx = var[..., 0] * tx * pw + pcx
        cy = var[..., 1] * ty * ph + pcy
        w = torch.exp(var[..., 2] * tw) * pw
        h = torch.exp(var[..., 3] * th) * ph
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                           -1)
    tw_ = tgt[:, 2] - tgt[:, 0]
    th_ = tgt[:, 3] - tgt[:, 1]
    tcx = tgt[:, 0] + 0.5 * tw_
    tcy = tgt[:, 1] + 0.5 * th_
    return torch.stack([(tcx - pcx) / pw / var[..., 0],
                        (tcy - pcy) / ph / var[..., 1],
                        torch.log(tw_ / pw) / var[..., 2],
                        torch.log(th_ / ph) / var[..., 3]], -1)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, name=None):
    """reference `operators/detection/distribute_fpn_proposals_op`: each
    RoI to the FPN level of its scale. Returns ([the RoIs of each level
    min..max], the int32 order that restores the input's)."""
    rois = tensor(fpn_rois)
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    scale = torch.sqrt(torch.clamp(w * h, min=1e-6))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-6)) + refer_level
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int64)
    outs, idxs = [], []
    for level in range(min_level, max_level + 1):
        sel = torch.nonzero(lvl == level).reshape(-1)
        outs.append(rois[sel])
        idxs.append(sel)
    restore = torch.argsort(torch.cat(idxs), stable=True)
    return outs, restore.to(torch.int32)


def _bce(logit, target):
    return torch.maximum(logit, torch.zeros_like(logit)) - logit * target \
        + torch.log1p(torch.exp(-torch.abs(logit)))


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    """reference `operators/detection/yolov3_loss_op.cc`, as the JAX
    package computes it: x [N, mask_num (5 + class_num), H, W] one head's
    raw output; gt_box [N, B, 4] (cx, cy, w, h normalised; a gt with w or
    h 0 is padding); gt_label [N, B]; anchors flat [w0, h0, ...] in input
    pixels; anchor_mask this scale's anchors. A gt goes to the anchor of
    best centred w/h IoU over all anchors, if that anchor is this
    scale's, at the cell of its centre. A sample's loss [N]: BCE on the
    x / y offsets, L1 on log w / h, both weighted 2 - w h; BCE on the
    objectness and the (label-smoothed) classes of the assigned cells;
    BCE toward 0 on the objectness of every other cell whose best IoU
    with a gt is at most ignore_thresh.

    The assigned-cell mask is a max-scatter (an OR): padded gts share
    index (n, 0, 0, 0) with real ones, so a scatter that kept an
    arbitrary writer could lose a True (the JAX package's `.at[].max`)."""
    all_anc = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask = list(anchor_mask)
    na = len(mask)
    args = named("yolov3_loss", x, gt_box, gt_label,
                 *(() if gt_score is None else (gt_score,)))
    feat, gbox, glabel = args[:3]
    dev = feat.device
    anc_all = torch.from_numpy(all_anc).to(dev)
    manc = torch.from_numpy(all_anc[mask]).to(dev)          # [na, 2]
    mask_t = torch.tensor(mask, device=dev)
    N, C, H, W = feat.shape
    feat = feat.reshape(N, na, 5 + class_num, H, W)
    in_w = W * downsample_ratio
    in_h = H * downsample_ratio
    B = gbox.shape[1]
    valid = (gbox[:, :, 2] > 0) & (gbox[:, :, 3] > 0)

    gw = gbox[:, :, 2] * in_w
    gh = gbox[:, :, 3] * in_h
    inter = torch.minimum(gw[..., None], anc_all[None, None, :, 0]) * \
        torch.minimum(gh[..., None], anc_all[None, None, :, 1])
    union = gw[..., None] * gh[..., None] + \
        (anc_all[:, 0] * anc_all[:, 1])[None, None] - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-9), -1)
    hit = best[..., None] == mask_t[None, None]             # [N, B, na]
    an_idx = torch.argmax(hit.to(torch.int32), -1)
    assigned = valid & hit.any(-1)

    gi = torch.clamp((gbox[:, :, 0] * W).to(torch.int32), 0, W - 1)
    gj = torch.clamp((gbox[:, :, 1] * H).to(torch.int32), 0, H - 1)
    tx = gbox[:, :, 0] * W - gi
    ty = gbox[:, :, 1] * H - gj
    ma = manc[an_idx]                                       # [N, B, 2]
    tw = torch.log(torch.clamp(gw, min=1e-9) / torch.clamp(ma[..., 0],
                                                           min=1e-9))
    th = torch.log(torch.clamp(gh, min=1e-9) / torch.clamp(ma[..., 1],
                                                           min=1e-9))
    box_w = 2.0 - gbox[:, :, 2] * gbox[:, :, 3]

    n_ix = torch.arange(N, device=dev)[:, None].expand(N, B)
    gil, gjl = gi.long(), gj.long()
    # the JAX package reads [N, na, W, H] at (n, a, gi, gj): the cell at
    # row gj, column gi
    picked = feat[n_ix, an_idx, :, gjl, gil]                # [N, B, 5 + cls]
    px, py, pw, ph, pobj = picked[..., :5].unbind(-1)
    pcls = picked[..., 5:]

    af = assigned.to(feat.dtype)
    w = af * box_w
    sc = args[3] if len(args) > 3 else torch.ones_like(w)
    loss_xy = (_bce(px, tx) + _bce(py, ty)) * w * sc
    loss_wh = (torch.abs(pw - tw) + torch.abs(ph - th)) * w * sc
    loss_obj_pos = _bce(pobj, torch.ones_like(pobj)) * af * sc
    smooth = min(1.0 / max(class_num, 1), 1.0 / 40) \
        if use_label_smooth else 0.0
    onehot = (glabel[..., None] == torch.arange(class_num, device=dev)
              ).to(torch.float32)
    onehot = onehot * (1 - 2 * smooth) + smooth
    loss_cls = _bce(pcls, onehot).sum(-1) * af * sc

    gx0 = torch.arange(W, dtype=torch.float32, device=dev)
    gy0 = torch.arange(H, dtype=torch.float32, device=dev)
    bx = (gx0[None, None, None] + torch.sigmoid(feat[:, :, 0])) / W
    by = (gy0[None, None, :, None] + torch.sigmoid(feat[:, :, 1])) / H
    bw = torch.exp(torch.clamp(feat[:, :, 2], -10, 10)) * \
        manc[None, :, 0, None, None] / in_w
    bh = torch.exp(torch.clamp(feat[:, :, 3], -10, 10)) * \
        manc[None, :, 1, None, None] / in_h
    g = gbox[:, :, None, None, None]                   # [N, B, 1, 1, 1, 4]
    gx1 = g[..., 0] - g[..., 2] / 2
    gx2 = g[..., 0] + g[..., 2] / 2
    gy1 = g[..., 1] - g[..., 3] / 2
    gy2 = g[..., 1] + g[..., 3] / 2
    iw = torch.clamp(torch.minimum((bx + bw / 2)[:, None], gx2)
                     - torch.maximum((bx - bw / 2)[:, None], gx1), min=0)
    ih = torch.clamp(torch.minimum((by + bh / 2)[:, None], gy2)
                     - torch.maximum((by - bh / 2)[:, None], gy1), min=0)
    inter_p = iw * ih
    ua = bw[:, None] * bh[:, None] + g[..., 2] * g[..., 3] - inter_p
    iou = inter_p / torch.clamp(ua, min=1e-9)
    best_iou = torch.where(valid[:, :, None, None, None], iou,
                           0.0).amax(1)                     # [N, na, H, W]

    flat = ((n_ix * na + an_idx) * H + gjl) * W + gil
    is_assigned = torch.zeros(N * na * H * W, dtype=torch.int32,
                              device=dev).scatter_reduce(
        0, flat.reshape(-1), assigned.reshape(-1).to(torch.int32), "amax")
    is_assigned = is_assigned.reshape(N, na, H, W).bool()
    noobj = (~is_assigned) & (best_iou <= ignore_thresh)
    loss_noobj = (_bce(feat[:, :, 4], torch.zeros_like(feat[:, :, 4]))
                  * noobj).sum((1, 2, 3))
    per_gt = loss_xy + loss_wh + loss_obj_pos + loss_cls
    return per_gt.sum(1) + loss_noobj


def _on(x, like):
    dev = like.device if torch.is_tensor(like) else None
    return tensor(x, dev)


def anchor_generator(input, anchor_sizes, aspect_ratios, variance=None,
                     stride=None, offset=0.5, name=None):
    """reference `operators/detection/anchor_generator_op.cc` (RPN
    anchors): one anchor a (size, ratio) pair at each cell, centred at
    `offset`, in image pixels (ratio = h / w). Returns (anchors
    [H, W, A, 4] xyxy, variances [H, W, A, 4]) on the input's device."""
    H, W = int(input.shape[2]), int(input.shape[3])
    stride = stride or [16.0, 16.0]
    variance = variance or [0.1, 0.1, 0.2, 0.2]
    combos = [(s, r) for r in aspect_ratios for s in anchor_sizes]
    A = len(combos)
    anc = np.zeros((H, W, A, 4), np.float32)
    cx = (np.arange(W) + offset) * stride[0]
    cy = (np.arange(H) + offset) * stride[1]
    for a, (s, r) in enumerate(combos):
        aw = s / float(np.sqrt(r))
        ah = s * float(np.sqrt(r))
        anc[:, :, a, 0] = cx[None, :] - aw / 2
        anc[:, :, a, 1] = cy[:, None] - ah / 2
        anc[:, :, a, 2] = cx[None, :] + aw / 2
        anc[:, :, a, 3] = cy[:, None] + ah / 2
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          (H, W, A, 4)).copy()
    return _on(anc, input), _on(var, input)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, flip=True, clip=False, steps=None,
              offset=0.5, name=None):
    """reference `operators/detection/prior_box_op.cc` (SSD priors):
    normalised [0, 1] boxes a cell from the min / max sizes and ratios.
    Returns (boxes [H, W, P, 4], variances [H, W, P, 4]) on the input's
    device."""
    H, W = int(input.shape[2]), int(input.shape[3])
    imH, imW = int(image.shape[2]), int(image.shape[3])
    ratios = [1.0]
    for r in list(aspect_ratios or [1.0]):
        if all(abs(r - e) > 1e-6 for e in ratios):
            ratios.append(r)
            if flip:
                ratios.append(1.0 / r)
    variance = variance or [0.1, 0.1, 0.2, 0.2]
    # the reference's sentinel: a step of 0 means image / feature size
    if not steps or steps[0] == 0 or steps[1] == 0:
        steps = [imW / W, imH / H]
    boxes = []
    for ms_i, ms in enumerate(min_sizes):
        for r in ratios:
            boxes.append((ms * np.sqrt(r), ms / np.sqrt(r)))
        if max_sizes:
            big = np.sqrt(ms * max_sizes[ms_i])
            boxes.append((big, big))
    out = np.zeros((H, W, len(boxes), 4), np.float32)
    cx = (np.arange(W) + offset) * steps[0] / imW
    cy = (np.arange(H) + offset) * steps[1] / imH
    for p, (bw, bh) in enumerate(boxes):
        out[:, :, p, 0] = cx[None, :] - bw / imW / 2
        out[:, :, p, 1] = cy[:, None] - bh / imH / 2
        out[:, :, p, 2] = cx[None, :] + bw / imW / 2
        out[:, :, p, 3] = cy[:, None] + bh / imH / 2
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          out.shape).copy()
    return _on(out, input), _on(var, input)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=True, name=None):
    """reference `operators/detection/generate_proposals_op.cc` (RPN):
    an image's top pre_nms_top_n anchors by score, their deltas decoded,
    clipped to the image, boxes under min_size dropped, NMS (pixel
    convention), post_nms_top_n kept. scores [N, A, H, W]; bbox_deltas
    [N, 4 A, H, W]; anchors / variances [H, W, A, 4]. Returns (rois
    [R, 4], scores [R, 1], rois_num [N] int32)."""
    sc = tensor(scores)
    dev = sc.device
    bd = tensor(bbox_deltas, dev)
    anc = tensor(anchors, dev).reshape(-1, 4)
    var = tensor(variances, dev).reshape(-1, 4)
    im = _host(img_size)
    N, A, H, W = sc.shape
    rois, roi_scores, nums = [], [], []
    for n in range(N):
        s = sc[n].permute(1, 2, 0).reshape(-1)
        d = bd[n].reshape(A, 4, H, W).permute(2, 3, 0, 1).reshape(-1, 4)
        order = torch.sort(s, descending=True, stable=True
                           ).indices[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], anc[order], var[order]
        aw = a[:, 2] - a[:, 0]
        ah = a[:, 3] - a[:, 1]
        acx = a[:, 0] + aw / 2
        acy = a[:, 1] + ah / 2
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        w = torch.exp(torch.clamp(v[:, 2] * d[:, 2], max=10.0)) * aw
        h = torch.exp(torch.clamp(v[:, 3] * d[:, 3], max=10.0)) * ah
        imh, imw = float(im[n, 0]), float(im[n, 1])
        x1 = torch.clamp(cx - w / 2, 0, imw - 1)
        y1 = torch.clamp(cy - h / 2, 0, imh - 1)
        x2 = torch.clamp(cx + w / 2, 0, imw - 1)
        y2 = torch.clamp(cy + h / 2, 0, imh - 1)
        keep = ((x2 - x1 + 1) >= min_size) & ((y2 - y1 + 1) >= min_size)
        boxes = torch.stack([x1, y1, x2, y2], 1)[keep]
        s = s[keep]
        kept = nms(boxes, iou_threshold=nms_thresh, scores=s,
                   top_k=post_nms_top_n, eta=eta, offset=1.0).long()
        rois.append(boxes[kept])
        roi_scores.append(s[kept, None])
        nums.append(int(kept.numel()))
    out = (torch.cat(rois, 0).float() if rois else
           torch.zeros(0, 4, device=dev),
           torch.cat(roi_scores, 0).float() if roi_scores else
           torch.zeros(0, 1, device=dev))
    if return_rois_num:
        return out + (torch.tensor(nums, dtype=torch.int32, device=dev),)
    return out


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=1000,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    """reference `operators/detection/multiclass_nms_op.cc`: per image,
    each class's boxes above score_threshold (at most nms_top_k, by
    falling score), greedy NMS within the class, then the kept boxes of
    every class by falling score, at most keep_top_k. bboxes [N, M, 4];
    scores [N, C, M]; class `background_label` skipped. Returns (out
    [R, 6] = (label, score, x1, y1, x2, y2), rois_num [N] int32), on the
    boxes' device. Each image's classes go through the scan at once: the
    sort and the IoU matrices on the device (module docstring)."""
    b = tensor(bboxes)
    dev = b.device
    s = tensor(scores, dev)
    N, C, M = s.shape
    classes = [c for c in range(C) if c != background_label]
    cls_t = torch.tensor(classes, dtype=torch.int64, device=dev)
    outs, nums = [], []
    for n in range(N):
        sn = s[n, cls_t]                                   # [G, M]
        passing = sn > score_threshold
        # the reference's slice [:nms_top_k] of each class's candidates
        counts = np.array([len(range(c)[:nms_top_k])
                           for c in _host(passing.sum(1))], np.int64)
        K = int(counts.max()) if counts.size else 0
        if K == 0:
            nums.append(0)
            continue
        masked = torch.where(passing, sn, torch.full_like(sn, -np.inf))
        top_s, top_i = torch.sort(masked, dim=1, descending=True,
                                  stable=True)
        top_s, top_i = top_s[:, :K], top_i[:, :K]
        kept = _greedy_groups(b[n][top_i].float(), counts, nms_threshold,
                              0.0 if normalized else 1.0, nms_eta)
        g_of = np.concatenate([np.full(len(k), g) for g, k in
                               enumerate(kept)]).astype(np.int64)
        pos = np.concatenate(kept).astype(np.int64)
        ks = _host(top_s)[g_of, pos]
        order = np.argsort(-ks, kind="stable")[:keep_top_k]
        g_t = torch.from_numpy(g_of[order]).to(dev)
        p_t = torch.from_numpy(pos[order]).to(dev)
        rows = torch.cat([cls_t[g_t].float()[:, None],
                          top_s[g_t, p_t][:, None].float(),
                          b[n][top_i[g_t, p_t]].float()], 1)
        outs.append(rows)
        nums.append(len(order))
    out = torch.cat(outs, 0) if outs else torch.zeros(0, 6, device=dev)
    return out, torch.tensor(nums, dtype=torch.int32, device=dev)
