"""The counter-based generator behind ``jax.random``, in numpy.

``repro.models.rwkv.feature_stream`` draws its fixed trunk from
``jax.random.PRNGKey(seed)``; the port reproduces those draws without JAX.
This is Threefry-2x32 (20 rounds, Salmon et al., SC'11) under JAX's
*partitionable* layout (``jax_threefry_partitionable=True``, the default
since JAX 0.5): a key is two uint32 words; ``split(key, n)`` and the bits
of an array of shape ``s`` both hash the 64-bit flat index of each element,
split into a high and a low word, under the key.

* :func:`split` and :func:`random_bits` equal ``jax.random.split`` and
  ``jax.random.bits`` bit for bit.
* :func:`uniform` equals ``jax.random.uniform`` bit for bit: 23 random
  mantissa bits under exponent 0, minus 1, scaled and shifted in f32.
* :func:`normal` is ``sqrt(2) * erfinv(u)`` of a uniform ``u`` in
  ``(nextafter(-1, 0), 1)``, as JAX draws it.  erfinv is XLA's
  single-precision polynomial (Giles 2010) with fused multiply-adds, but
  XLA evaluates its ``log1p`` with its own approximation, which numpy does
  not reproduce to the last bit: about 99% of draws are bit-identical and
  the rest within 3 f32 ulps (``tests/test_torch_rwkv.py`` pins the
  bound).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the word pairs ``(x0, x1)`` under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed in ``[0, 2**32)``: the
    words ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    return (int(seed) >> 32) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF


def _counts(shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return hi, lo


def split(key: Tuple[int, int], num: int = 2) -> list:
    """``jax.random.split(key, num)`` as a list of word pairs."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, *_counts((num,)))
    return [(int(a), int(b)) for a, b in zip(b0, b1)]


def random_bits(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32)."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, *_counts(tuple(shape)))
    return b0 ^ b1


def uniform(key: Tuple[int, int], shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    """XLA's single-precision erfinv (Giles' polynomial in ``w =
    -log1p(-x^2)``, two branches at w = 5) in f32, each Horner step one
    fused multiply-add (emulated in f64 and rounded once)."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(f32)
    small = w < f32(5.0)
    w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(small, f32(_ERFINV_SMALL[0]), f32(_ERFINV_LARGE[0]))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, f32(a), f32(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w.astype(np.float64)).astype(f32)
    return (p * x).astype(f32)


def normal(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)`` to within a few f32 ulps
    (see the module docstring)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(math.sqrt(2)) * _erfinv32(u)).astype(np.float32)
