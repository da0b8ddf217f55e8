"""paddle_tpu_torch.vision.transforms and .datasets held to
paddle_tpu.vision's.

- Every name of the transforms' `__all__`, on the same uint8 images, in
  both packages after one `random.seed` and `np.random.seed`: the same
  array, bit for bit, the same type. That pins the reproduced quirks
  (ROADMAP C27): `resize` is nearest-neighbour whatever `interpolation`
  says, `to_tensor` divides by 255 only when the maximum exceeds 1.5.
  The ImageNet training transform (`RandomResizedCrop(224)`,
  `RandomHorizontalFlip`, `ToTensor`, `Normalize`) over a 256 x 256
  image, exact too.
- Worker processes get no seed (ROADMAP C26, reproduced): they inherit
  the parent's numpy state, so two workers draw the same numpy numbers,
  and Python reseeds `random` from the OS in a forked child, so their
  `random` draws follow no seed; random transforms are held on the
  in-process path only.
- The datasets' synthetic fallbacks (`MNIST`, `FashionMNIST`,
  `Cifar10`, `Cifar100`, `Flowers`) equal the JAX package's, with the
  same warning; an MNIST idx pair of gzip files and a Cifar tar the test
  writes read back equal in both.
"""
import gzip
import io as pyio
import pickle
import random
import struct
import tarfile
import time
import warnings

import numpy as np
import pytest

from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jT
from paddle_tpu_torch import io
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as tT


def _img(h=40, w=52, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c)) \
        .astype(np.uint8)


CASES = {
    "Compose": lambda T: T.Compose([T.CenterCrop(20), T.ToTensor()]),
    "ToTensor": lambda T: T.ToTensor(),
    "ToTensor_HWC": lambda T: T.ToTensor(data_format="HWC"),
    "Normalize": lambda T: T.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4],
                                       data_format="HWC"),
    "Resize": lambda T: T.Resize(17),
    "Resize_hw": lambda T: T.Resize((23, 31), interpolation="bicubic"),
    "RandomCrop": lambda T: T.RandomCrop(21, padding=3),
    "CenterCrop": lambda T: T.CenterCrop((19, 30)),
    "RandomHorizontalFlip": lambda T: T.RandomHorizontalFlip(0.5),
    "RandomVerticalFlip": lambda T: T.RandomVerticalFlip(0.5),
    "Transpose": lambda T: T.Transpose(),
    "BrightnessTransform": lambda T: T.BrightnessTransform(0.4),
    "Pad": lambda T: T.Pad((1, 2, 3, 4)),
    "Pad_int": lambda T: T.Pad(2),
    "RandomResizedCrop": lambda T: T.RandomResizedCrop(24),
    "to_tensor": lambda T: T.to_tensor,
    "to_tensor_unit": lambda T: (lambda im: T.to_tensor(im / 255.0)),
    "normalize": lambda T: (lambda im: T.normalize(
        T.to_tensor(im), [0.4, 0.5, 0.6], [0.2, 0.2, 0.2])),
    "resize": lambda T: (lambda im: T.resize(im, (11, 60))),
    "hflip": lambda T: T.hflip,
    "vflip": lambda T: T.vflip,
}


def test_cases_cover_every_transform():
    covered = {k.split("_")[0] if k[0].isupper() else k for k in CASES}
    covered |= {"to_tensor", "normalize", "resize"}
    assert set(jT.__all__) == set(tT.__all__) <= covered


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_jax(name):
    for seed in range(4):
        img = _img(seed=seed)
        out = []
        for T in (jT, tT):
            random.seed(seed)
            np.random.seed(seed)
            out.append([np.asarray(CASES[name](T)(img)) for _ in range(3)])
        for j, t in zip(*out):
            assert t.dtype == j.dtype and t.shape == j.shape
            assert t.tobytes() == j.tobytes()


def test_imagenet_train_transform_matches_jax():
    def make(T):
        return T.Compose([T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
                          T.ToTensor(), T.Normalize(
                              mean=[0.485, 0.456, 0.406],
                              std=[0.229, 0.224, 0.225])])
    imgs = [_img(256, 256, seed=s) for s in range(3)]
    out = []
    for T in (jT, tT):
        random.seed(11)
        f = make(T)
        out.append([f(im) for im in imgs])
    for j, t in zip(*out):
        assert t.shape == j.shape == (3, 224, 224) and t.dtype == np.float32
        assert t.tobytes() == j.tobytes()


class _Draws(io.Dataset):
    def __getitem__(self, i):
        time.sleep(0.5)   # both workers take tasks
        return np.float64(random.random()), np.random.random()

    def __len__(self):
        return 6


def test_workers_draws_are_not_seeded():
    """C26, reproduced: no worker is given a seed. Each starts from the
    parent's numpy state, so the workers' numpy draws repeat each
    other's; Python reseeds `random` from the OS in a forked child, so
    their `random` draws follow no seed the parent set."""
    random.seed(7)
    np.random.seed(7)
    stream = [random.random() for _ in range(6)]
    nstream = np.float32(np.random.random(6)).tolist()
    random.seed(7)
    np.random.seed(7)
    got = [(float(a[0]), float(b[0])) for a, b in io.DataLoader(
        _Draws(), batch_size=1, num_workers=2)]
    draws, ndraws = [g[0] for g in got], [g[1] for g in got]
    assert len(got) == 6 and set(ndraws) <= set(nstream)
    assert ndraws[0] == ndraws[1] == nstream[0]   # each worker's first
    assert not set(draws) & set(np.float32(stream).tolist())


@pytest.mark.parametrize("cls,mode", [
    ("MNIST", "train"), ("MNIST", "test"), ("FashionMNIST", "train"),
    ("Cifar10", "train"), ("Cifar100", "test"), ("Flowers", "train")])
def test_synthetic_datasets_match_jax(cls, mode):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = getattr(jds, cls)(mode=mode)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = getattr(tds, cls)(mode=mode)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert len(t) == len(j)
    assert t.images.tobytes() == j.images.tobytes()
    assert np.array_equal(t.labels, j.labels)
    for i in (0, len(j) - 1):
        (ti, tl), (ji, jl) = t[i], j[i]
        assert ti.dtype == ji.dtype and ti.tobytes() == ji.tobytes()
        assert tl == jl and tl.dtype == jl.dtype
    tt = getattr(tds, cls)(mode=mode, transform=tT.ToTensor())
    jt = getattr(jds, cls)(mode=mode, transform=jT.ToTensor())
    assert tt[3][0].tobytes() == jt[3][0].tobytes()


def _write_mnist(tmp_path, n=7):
    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    ip, lp = tmp_path / "img.gz", tmp_path / "lab.gz"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return str(ip), str(lp), images, labels


def _write_cifar(tmp_path, n=5, fine=False):
    rng = np.random.RandomState(4)
    path = tmp_path / "cifar.tar"
    with tarfile.open(path, "w") as tf:
        for name in ("data_batch_1", "data_batch_2", "test_batch"):
            key = b"fine_labels" if fine else b"labels"
            blob = pickle.dumps({
                b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                key: rng.randint(0, 10, n).tolist()})
            info = tarfile.TarInfo(f"cifar/{name}")
            info.size = len(blob)
            tf.addfile(info, pyio.BytesIO(blob))
    return str(path)


def test_local_files_read_back_as_jax(tmp_path):
    ip, lp, images, labels = _write_mnist(tmp_path)
    t, j = tds.MNIST(ip, lp), jds.MNIST(ip, lp)
    assert t.images.tobytes() == j.images.tobytes() == images.tobytes()
    assert np.array_equal(t.labels, labels.astype(np.int64))
    assert t[2][0].tobytes() == j[2][0].tobytes()
    for fine, cls in ((False, "Cifar10"), (True, "Cifar100")):
        path = _write_cifar(tmp_path, fine=fine)
        for mode, n in (("train", 10), ("test", 5)):
            t = getattr(tds, cls)(path, mode=mode)
            j = getattr(jds, cls)(path, mode=mode)
            assert len(t) == len(j) == n
            assert t.images.shape == (n, 32, 32, 3)
            assert t.images.tobytes() == j.images.tobytes()
            assert np.array_equal(t.labels, j.labels)
            assert t[1][0].tobytes() == j[1][0].tobytes()
