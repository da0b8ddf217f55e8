"""YOLOv3 (port of `paddle_tpu.vision.models.yolov3`; reference
PaddleDetection's YOLOv3 over `operators/detection/{yolov3_loss,yolo_box,
multiclass_nms}`).

A DarkNet-style backbone of strided 3 x 3 stages with a 1 x 1 / 3 x 3
residual each, a neck that upsamples (nearest, x 2) and concatenates,
and one 1 x 1 head a scale (strides 32, 16, 8). `forward` returns the
three raw head outputs, `loss` sums `vision.ops.yolov3_loss` over them
and `predict` decodes them with `vision.ops.yolo_box`. `width` 64 is the
full DarkNet width. The layers keep the JAX model's names, so
`models.load_reference_state` carries a JAX state dict across, the
BatchNorms' `_mean` / `_variance` included. A model is built on `device`
(the CUDA card unless the caller passes another) with its weights drawn
from one generator seeded with `seed` (`_common.init_weights`).
`pretrained=True` warns and keeps random weights, as the JAX package does
offline; nothing is downloaded."""
from __future__ import annotations

import warnings

import torch
from torch import nn

from ... import nn as pnn
from ...nn import functional as F
from ..ops import yolo_box, yolov3_loss
from ._common import building_on, init_weights

__all__ = ["YOLOv3", "yolov3"]

# the anchors (COCO's), flat [w, h] pairs; the large ones go with the
# coarse stride-32 head
_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
            116, 90, 156, 198, 373, 326]
_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
_STRIDES = (32, 16, 8)


def _conv_bn(cin, cout, k, stride=1):
    return pnn.Sequential(
        pnn.Conv2D(cin, cout, k, stride=stride, padding=k // 2,
                   bias_attr=False),
        pnn.BatchNorm2D(cout),
        pnn.LeakyReLU(0.1))


class _Stage(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.down = _conv_bn(cin, cout, 3, stride=2)
        self.conv1 = _conv_bn(cout, cout // 2, 1)
        self.conv2 = _conv_bn(cout // 2, cout, 3)

    def forward(self, x):
        x = self.down(x)
        return x + self.conv2(self.conv1(x))


class YOLOv3(nn.Module):
    """Three-scale YOLOv3 at `width` (64 is DarkNet-53's widths; the JAX
    package's default 16 keeps it small)."""

    def __init__(self, num_classes=80, width=16, device=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        w = width
        co = 3 * (5 + num_classes)
        with building_on(device):
            self.stem = _conv_bn(3, w, 3)
            self.c2 = _Stage(w, w * 2)
            self.c3 = _Stage(w * 2, w * 4)
            self.c4 = _Stage(w * 4, w * 8)
            self.c5 = _Stage(w * 8, w * 16)
            self.c6 = _Stage(w * 16, w * 32)
            self.head5 = pnn.Conv2D(w * 32, co, 1)
            self.lat5 = _conv_bn(w * 32, w * 8, 1)
            self.head4 = pnn.Conv2D(w * 16 + w * 8, co, 1)
            self.lat4 = _conv_bn(w * 16 + w * 8, w * 4, 1)
            self.head3 = pnn.Conv2D(w * 8 + w * 4, co, 1)
        init_weights(self, seed)

    def forward(self, x):
        x = self.stem(x)
        x = self.c3(self.c2(x))
        p3 = self.c4(x)
        p4 = self.c5(p3)
        p5 = self.c6(p4)
        out5 = self.head5(p5)
        up5 = F.interpolate(self.lat5(p5), scale_factor=2, mode="nearest")
        m4 = torch.cat([p4, up5], 1)
        out4 = self.head4(m4)
        up4 = F.interpolate(self.lat4(m4), scale_factor=2, mode="nearest")
        m3 = torch.cat([p3, up4], 1)
        out3 = self.head3(m3)
        # stride 32, 16, 8: the order of the anchor masks
        return [out5, out4, out3]

    def loss(self, outputs, gt_box, gt_label, gt_score=None,
             ignore_thresh=0.7):
        """A sample's loss [N]: `yolov3_loss` summed over the scales."""
        total = None
        for out, mask, ds in zip(outputs, _MASKS, _STRIDES):
            part = yolov3_loss(out, gt_box, gt_label, _ANCHORS, mask,
                               self.num_classes, ignore_thresh,
                               downsample_ratio=ds, gt_score=gt_score)
            total = part if total is None else total + part
        return total

    def predict(self, outputs, img_size, conf_thresh=0.01):
        """(boxes [N, M, 4], scores [N, M, classes]) of the three scales
        (`yolo_box`), concatenated; feed `multiclass_nms` the scores
        transposed to [N, classes, M]."""
        boxes, scores = [], []
        for out, mask, ds in zip(outputs, _MASKS, _STRIDES):
            anc = [a for m in mask for a in _ANCHORS[2 * m:2 * m + 2]]
            b, s = yolo_box(out, img_size, anc, self.num_classes,
                            conf_thresh=conf_thresh, downsample_ratio=ds)
            boxes.append(b)
            scores.append(s)
        return torch.cat(boxes, 1), torch.cat(scores, 1)


def yolov3(pretrained=False, num_classes=80, **kwargs):
    if pretrained:
        warnings.warn("pretrained YOLOv3 weights unavailable offline; "
                      "returning a randomly initialized model")
    return YOLOv3(num_classes=num_classes, **kwargs)
