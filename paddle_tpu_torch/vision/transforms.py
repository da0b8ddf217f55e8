"""Vision transforms (port of `paddle_tpu.vision.transforms`; reference
`python/paddle/vision/transforms/`): numpy arrays in HWC (and CHW after
`ToTensor`), composable; they run in `DataLoader` workers.

The JAX package's arithmetic is reproduced exactly (ROADMAP C27):
`resize` (and so `Resize` and `RandomResizedCrop`) is nearest-neighbour
whatever `interpolation` says, `to_tensor` divides by 255 only when the
image's maximum exceeds 1.5, the random transforms draw from Python's
`random` and `BrightnessTransform` from numpy's global generator."""
from __future__ import annotations

import numbers
import random
from typing import Sequence

import numpy as np

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "RandomCrop",
           "CenterCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "BrightnessTransform", "Pad", "RandomResizedCrop",
           "to_tensor", "normalize", "resize", "hflip", "vflip"]


def _hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class ToTensor:
    """HWC uint8 → CHW float32 in [0,1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        return to_tensor(img, self.data_format)


def to_tensor(img, data_format="CHW"):
    img = _hwc(img).astype("float32")
    if img.max() > 1.5:
        img = img / 255.0
    if data_format == "CHW":
        img = img.transpose(2, 0, 1)
    return img


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype="float32")
        self.std = np.asarray(std, dtype="float32")
        self.data_format = data_format

    def __call__(self, img):
        return normalize(np.asarray(img, dtype="float32"), self.mean,
                         self.std, self.data_format)


def normalize(img, mean, std, data_format="CHW"):
    mean = np.asarray(mean, dtype="float32")
    std = np.asarray(std, dtype="float32")
    if data_format == "CHW":
        shape = (-1, 1, 1)
    else:
        shape = (1, 1, -1)
    return (img - mean.reshape(shape)) / std.reshape(shape)


def _resize_np(img, size):
    """nearest-neighbor resize without external deps."""
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h < w:
            nh, nw = size, int(size * w / h)
        else:
            nh, nw = int(size * h / w), size
    else:
        nh, nw = size
    ys = (np.arange(nh) * (h / nh)).astype(int).clip(0, h - 1)
    xs = (np.arange(nw) * (w / nw)).astype(int).clip(0, w - 1)
    return img[ys][:, xs]


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = size

    def __call__(self, img):
        return resize(_hwc(img), self.size)


def resize(img, size, interpolation="bilinear"):
    return _resize_np(_hwc(img), size)


class RandomCrop:
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        img = _hwc(img)
        if self.padding:
            p = self.padding
            img = np.pad(img, ((p, p), (p, p), (0, 0)))
        h, w = img.shape[:2]
        th, tw = self.size
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        return img[i:i + th, j:j + tw]


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = _hwc(img)
        h, w = img.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[i:i + th, j:j + tw]


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img):
        img = _hwc(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = random.uniform(*self.ratio)
            tw = int(round(np.sqrt(target * ar)))
            th = int(round(np.sqrt(target / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = random.randint(0, h - th)
                j = random.randint(0, w - tw)
                return _resize_np(img[i:i + th, j:j + tw], self.size)
        return _resize_np(img, self.size)


def hflip(img):
    return _hwc(img)[:, ::-1]


def vflip(img):
    return _hwc(img)[::-1]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if random.random() < self.prob:
            return hflip(img)
        return _hwc(img)


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if random.random() < self.prob:
            return vflip(img)
        return _hwc(img)


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return _hwc(img).transpose(self.order)


class BrightnessTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        alpha = 1 + np.random.uniform(-self.value, self.value)
        return np.clip(_hwc(img) * alpha, 0, 255).astype(_hwc(img).dtype)


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = padding

    def __call__(self, img):
        p = self.padding
        if isinstance(p, numbers.Number):
            p = (p, p, p, p)
        img = _hwc(img)
        return np.pad(img, ((p[1], p[3]), (p[0], p[2]), (0, 0)))
