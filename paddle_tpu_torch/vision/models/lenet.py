"""LeNet (port of `paddle_tpu.vision.models.lenet`; reference
`python/paddle/vision/models/lenet.py`), built and drawn as the ResNets
are (`resnet.py`)."""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ._common import building_on, init_weights

__all__ = ["LeNet"]


class LeNet(nn.Module):
    def __init__(self, num_classes=10, device=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        with building_on(device):
            self.features = pnn.Sequential(
                pnn.Conv2D(1, 6, 3, stride=1, padding=1),
                pnn.ReLU(),
                pnn.MaxPool2D(2, 2),
                pnn.Conv2D(6, 16, 5, stride=1, padding=0),
                pnn.ReLU(),
                pnn.MaxPool2D(2, 2))
            if num_classes > 0:
                self.fc = pnn.Sequential(
                    pnn.Linear(400, 120),
                    pnn.Linear(120, 84),
                    pnn.Linear(84, num_classes))
        init_weights(self, seed)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
