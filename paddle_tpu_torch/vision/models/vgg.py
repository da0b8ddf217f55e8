"""VGG (port of `paddle_tpu.vision.models.vgg`; reference
`python/paddle/vision/models/vgg.py`), built and drawn as the ResNets
are (`resnet.py`): `_make_layers` and `VGG(features)` build on the
device in force, `vgg11`-`vgg19` on their `device=` argument."""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ._common import building_on, init_weights

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg, batch_norm=False):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(pnn.MaxPool2D(2, 2))
        else:
            layers.append(pnn.Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(pnn.BatchNorm2D(v))
            layers.append(pnn.ReLU())
            in_c = v
    return pnn.Sequential(*layers)


class VGG(nn.Module):
    def __init__(self, features, num_classes=1000, with_pool=True,
                 seed=0):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = pnn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            with torch.device(next(features.parameters()).device):
                self.classifier = pnn.Sequential(
                    pnn.Linear(512 * 7 * 7, 4096), pnn.ReLU(), pnn.Dropout(),
                    pnn.Linear(4096, 4096), pnn.ReLU(), pnn.Dropout(),
                    pnn.Linear(4096, num_classes))
        init_weights(self, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _vgg(cfg, batch_norm=False, pretrained=False, device=None, **kwargs):
    with building_on(device):
        features = _make_layers(_cfgs[cfg], batch_norm)
    return VGG(features, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
