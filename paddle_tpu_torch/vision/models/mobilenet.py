"""MobileNetV1/V2 (port of `paddle_tpu.vision.models.mobilenet`; reference
`python/paddle/vision/models/mobilenetv1.py`, `mobilenetv2.py`), built
and drawn as the ResNets are (`resnet.py`). The depthwise convolutions
are grouped `Conv2D`s (groups = channels); V2 runs `ReLU6`."""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ._common import building_on, init_weights

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


class ConvBNLayer(nn.Module):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1,
                 act="relu"):
        super().__init__()
        self.conv = pnn.Conv2D(in_c, out_c, kernel, stride=stride,
                               padding=padding, groups=groups,
                               bias_attr=False)
        self.bn = pnn.BatchNorm2D(out_c)
        self.act = (pnn.ReLU6() if act == "relu6" else pnn.ReLU() if act
                    else None)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_c, out_c1, out_c2, stride, scale):
        super().__init__()
        c1 = int(out_c1 * scale)
        c2 = int(out_c2 * scale)
        self.dw = ConvBNLayer(in_c, c1, 3, stride, 1, groups=in_c)
        self.pw = ConvBNLayer(c1, c2, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)
        cfg = [(s(32), 32, 64, 1), (s(64), 64, 128, 2),
               (s(128), 128, 128, 1), (s(128), 128, 256, 2),
               (s(256), 256, 256, 1), (s(256), 256, 512, 2)] + \
              [(s(512), 512, 512, 1)] * 5 + \
              [(s(512), 512, 1024, 2), (s(1024), 1024, 1024, 1)]
        with building_on(device):
            self.conv1 = ConvBNLayer(3, s(32), 3, 2, 1)
            self.blocks = pnn.Sequential(*[
                DepthwiseSeparable(ic, c1, c2, st, scale)
                for ic, c1, c2, st in cfg])
            if with_pool:
                self.pool = pnn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.fc = pnn.Linear(s(1024), num_classes)
        init_weights(self, seed)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden, 1, act="relu6"))
        layers += [
            ConvBNLayer(hidden, hidden, 3, stride, 1, groups=hidden,
                        act="relu6"),
            ConvBNLayer(hidden, oup, 1, act=None)]
        self.conv = pnn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = int(32 * scale)
        last_c = int(1280 * max(1.0, scale))
        with building_on(device):
            feats = [ConvBNLayer(3, in_c, 3, 2, 1, act="relu6")]
            for t, c, n, st in cfg:
                out_c = int(c * scale)
                for i in range(n):
                    feats.append(InvertedResidual(in_c, out_c,
                                                  st if i == 0 else 1, t))
                    in_c = out_c
            feats.append(ConvBNLayer(in_c, last_c, 1, act="relu6"))
            self.features = pnn.Sequential(*feats)
            if with_pool:
                self.pool = pnn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = pnn.Sequential(
                    pnn.Dropout(0.2), pnn.Linear(last_c, num_classes))
        init_weights(self, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
