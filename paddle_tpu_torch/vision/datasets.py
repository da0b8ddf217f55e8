"""Vision datasets (port of `paddle_tpu.vision.datasets`; reference
`python/paddle/vision/datasets/`).

Nothing is downloaded (`download=True` fetches nothing): `MNIST` /
`FashionMNIST` read the reference's gzip idx files and `Cifar10` /
`Cifar100` its pickled tar when the paths given exist; otherwise, and
for `Flowers` always, they fall back to the JAX package's seeded
synthetic arrays, of the same shapes and types, with the same warning.
Samples are numpy arrays, as the JAX package's, for `io.DataLoader` to
collate.
"""
from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers"]


def _synthetic(n, shape, num_classes, seed):
    rng = np.random.RandomState(seed)
    images = (rng.rand(n, *shape) * 255).astype("uint8")
    labels = rng.randint(0, num_classes, size=(n,)).astype("int64")
    return images, labels


class MNIST(Dataset):
    NUM_CLASSES = 10

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        images = labels = None
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                images = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                    n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                f.read(8)
                labels = np.frombuffer(f.read(), dtype=np.uint8).astype(
                    "int64")
        if images is None:
            warnings.warn(f"{type(self).__name__}: no local data; using "
                          "deterministic synthetic samples (offline env)")
            n = 1024 if mode == "train" else 256
            images, labels = _synthetic(
                n, (28, 28), self.NUM_CLASSES,
                seed=42 if mode == "train" else 43)
        self.images = images
        self.labels = labels

    def __getitem__(self, idx):
        img = self.images[idx].astype("float32")[None, :, :] / 255.0
        if self.transform is not None:
            img = self.transform(self.images[idx])
        return img, np.asarray(self.labels[idx], dtype="int64")

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if data_file and os.path.exists(data_file):
            import pickle
            import tarfile
            datas, labels = [], []
            with tarfile.open(data_file) as tf:
                names = [n for n in tf.getnames()
                         if ("data_batch" in n if mode == "train"
                             else "test_batch" in n)]
                for name in sorted(names):
                    d = pickle.load(tf.extractfile(name), encoding="bytes")
                    datas.append(d[b"data"])
                    labels.extend(d.get(b"labels", d.get(b"fine_labels")))
            self.images = np.concatenate(datas).reshape(-1, 3, 32, 32) \
                .transpose(0, 2, 3, 1)
            self.labels = np.asarray(labels, dtype="int64")
        else:
            warnings.warn(f"{type(self).__name__}: no local data; using "
                          "deterministic synthetic samples (offline env)")
            n = 1024 if mode == "train" else 256
            self.images, self.labels = _synthetic(
                n, (32, 32, 3), self.NUM_CLASSES,
                seed=44 if mode == "train" else 45)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype("float32").transpose(2, 0, 1) / 255.0
        return img, np.asarray(self.labels[idx], dtype="int64")

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


class Flowers(Dataset):
    NUM_CLASSES = 102

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        warnings.warn("Flowers: synthetic fallback (offline env)")
        n = 512 if mode == "train" else 128
        self.images, self.labels = _synthetic(n, (64, 64, 3),
                                              self.NUM_CLASSES, seed=46)
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype("float32").transpose(2, 0, 1) / 255.0
        return img, np.asarray(self.labels[idx], dtype="int64")

    def __len__(self):
        return len(self.images)
