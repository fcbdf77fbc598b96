"""Deterministic synthetic surrogates for the paper's three datasets
(the port's own copy of ``repro.data.synthetic``, numpy only).

The generators are the reference's, line for line, so both packages build
byte-identical arrays from the same arguments:

  * mnist-like   : 784-d inputs in [0, 1]; class-conditional "stroke"
                   templates (low-rank structure + pixel noise), 10 classes.
  * jsc-like     : 16 continuous features, 5 classes, class-dependent means
                   and covariances (two variants differing in noise level).
  * nid-like     : 593 one-bit inputs, binary labels, with only a small
                   informative subset (49 bits).

If real datasets are placed under ``data/<name>/data.npz`` (or
``$REPRO_DATA_DIR/<name>``) the loaders pick them up instead.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Tuple

import numpy as np

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class Dataset:
    """Train and test arrays of one task, with its class count."""

    name: str
    x_train: Array
    y_train: Array
    x_test: Array
    y_test: Array
    n_classes: int

    @property
    def in_features(self) -> int:
        """Width of one input row."""
        return self.x_train.shape[-1]


def _real_data_path(name: str) -> str:
    return os.path.join(os.environ.get("REPRO_DATA_DIR", "data"), name)


def _maybe_real(name: str):
    path = _real_data_path(name)
    f = os.path.join(path, "data.npz")
    if os.path.exists(f):
        z = np.load(f)
        return Dataset(name=name, x_train=z["x_train"], y_train=z["y_train"],
                       x_test=z["x_test"], y_test=z["y_test"],
                       n_classes=int(z["n_classes"]))
    return None


def mnist_like(n_train: int = 20_000, n_test: int = 4_000,
               seed: int = 0) -> Dataset:
    """MNIST-like: 784 pixels in [0, 1] from per-class stroke templates."""
    real = _maybe_real("mnist")
    if real:
        return real
    rng = np.random.default_rng(seed)
    n_classes, d = 10, 784
    # class templates: sparse smooth "strokes" = sum of a few blurred lines
    templates = np.zeros((n_classes, 28, 28), np.float32)
    for c in range(n_classes):
        g = np.random.default_rng(1000 + c)
        img = np.zeros((28, 28), np.float32)
        for _ in range(3 + c % 3):
            x0, y0 = g.integers(4, 24, 2)
            dx, dy = g.uniform(-1, 1, 2)
            for t in range(18):
                xi = int(np.clip(x0 + dx * t, 0, 27))
                yi = int(np.clip(y0 + dy * t, 0, 27))
                img[xi, yi] = 1.0
        # blur
        k = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 16
        pad = np.pad(img, 1)
        img = sum(k[i, j] * pad[i:i + 28, j:j + 28]
                  for i in range(3) for j in range(3))
        templates[c] = img / max(img.max(), 1e-6)

    def sample(n, rs):
        y = rs.integers(0, n_classes, n)
        base = templates[y].reshape(n, d)
        jitter = rs.normal(0, 0.25, (n, d)).astype(np.float32)
        x = np.clip(base + jitter * (base > 0.05) + rs.normal(
            0, 0.05, (n, d)).astype(np.float32), 0, 1)
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train, np.random.default_rng(seed + 1))
    x_te, y_te = sample(n_test, np.random.default_rng(seed + 2))
    return Dataset("mnist-like", x_tr, y_tr, x_te, y_te, n_classes)


def jsc_like(variant: str = "openml", n_train: int = 40_000,
             n_test: int = 8_000, seed: int = 0) -> Dataset:
    """JSC-like: 16 features, 5 classes; ``cernbox`` is the noisier one."""
    real = _maybe_real(f"jsc_{variant}")
    if real:
        return real
    rng = np.random.default_rng(seed + (0 if variant == "openml" else 7))
    n_classes, d = 5, 16
    noise = 0.55 if variant == "openml" else 0.75  # CERNBox = noisier
    means = np.random.default_rng(42).normal(0, 1.0, (n_classes, d))
    mix = np.random.default_rng(43).normal(0, 0.4, (n_classes, d, d))

    def sample(n, rs):
        y = rs.integers(0, n_classes, n)
        z = rs.normal(0, 1, (n, d)).astype(np.float32)
        x = means[y] + np.einsum("nd,ndk->nk", z, mix[y]) + \
            rs.normal(0, noise, (n, d))
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train, np.random.default_rng(seed + 1))
    x_te, y_te = sample(n_test, np.random.default_rng(seed + 2))
    return Dataset(f"jsc-{variant}-like", x_tr, y_tr, x_te, y_te, n_classes)


def nid_like(n_train: int = 30_000, n_test: int = 6_000,
             seed: int = 0) -> Dataset:
    """NID-like: 593 one-bit inputs, binary labels from 49 of them."""
    real = _maybe_real("nid")
    if real:
        return real
    d, informative = 593, 49
    g = np.random.default_rng(77)
    info_idx = g.choice(d, informative, replace=False)
    w = g.normal(0, 1.0, informative)

    def sample(n, rs):
        x = (rs.random((n, d)) < 0.35).astype(np.float32)
        score = x[:, info_idx] @ w
        y = (score + rs.normal(0, 0.5, n) > np.median(score)).astype(np.int32)
        return x, y

    x_tr, y_tr = sample(n_train, np.random.default_rng(seed + 1))
    x_te, y_te = sample(n_test, np.random.default_rng(seed + 2))
    return Dataset("nid-like", x_tr, y_tr, x_te, y_te, 2)


@dataclasses.dataclass(frozen=True)
class SeqDataset:
    """A :class:`Dataset` whose rows are consumed as *streams*: each example
    is a ``[T, n_in]`` sequence of per-step feature chunks, labelled once
    (classification of the whole stream)."""

    name: str
    x_train: Array   # [N, T, n_in]
    y_train: Array
    x_test: Array
    y_test: Array
    n_classes: int

    @property
    def n_in(self) -> int:
        """Features per step."""
        return self.x_train.shape[-1]

    @property
    def seq_len(self) -> int:
        """Steps per sequence."""
        return self.x_train.shape[1]


def to_sequences(data: Dataset, chunk: int) -> SeqDataset:
    """SeqMNIST-style stream conversion: split each flat ``[D]`` row into
    ``T = D // chunk`` steps of ``chunk`` features, presented in order."""
    d = data.x_train.shape[-1]
    if d % chunk:
        raise ValueError(f"in_features {d} not divisible by chunk {chunk}")
    t = d // chunk

    def seq(x):
        return np.ascontiguousarray(x.reshape(x.shape[0], t, chunk))

    return SeqDataset(name=f"{data.name}-seq{chunk}",
                      x_train=seq(data.x_train), y_train=data.y_train,
                      x_test=seq(data.x_test), y_test=data.y_test,
                      n_classes=data.n_classes)


def load(name: str, **kw) -> Dataset:
    """The dataset registered as ``name`` (mnist, jsc_openml, jsc_cernbox,
    nid)."""
    if name == "mnist":
        return mnist_like(**kw)
    if name in ("jsc_openml", "jsc-openml"):
        return jsc_like("openml", **kw)
    if name in ("jsc_cernbox", "jsc-cernbox"):
        return jsc_like("cernbox", **kw)
    if name == "nid":
        return nid_like(**kw)
    raise ValueError(f"unknown dataset {name!r}")


def batches(x: Array, y: Array, batch_size: int, *, seed: int = 0,
            epochs: int = 1) -> Iterator[Tuple[Array, Array]]:
    """Shuffled epoch iterator (host-side; sharding happens at device_put)."""
    n = x.shape[0]
    for e in range(epochs):
        rs = np.random.default_rng(seed + e)
        perm = rs.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            yield x[idx], y[idx]


def augment_shift(x: Array, rs: np.random.Generator,
                  max_shift: int = 2) -> Array:
    """MNIST-style augmentation (the paper's ``+aug`` variant): random
    +-2px translations."""
    n = x.shape[0]
    img = x.reshape(n, 28, 28)
    out = np.zeros_like(img)
    sx = rs.integers(-max_shift, max_shift + 1, n)
    sy = rs.integers(-max_shift, max_shift + 1, n)
    for i in range(n):
        out[i] = np.roll(np.roll(img[i], sx[i], axis=0), sy[i], axis=1)
    return out.reshape(n, -1)
