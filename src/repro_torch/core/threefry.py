"""The parts of ``jax.random`` that the sketch codec's bases come from, in
numpy (the port's own copy: it imports neither JAX nor the JAX package).

The reference derives each sketch basis (``repro.core.channel.Channel.
_basis``) as ``qr(normal(fold_in(fold_in(key(seed), idx), rnd), (dim,
rank), float32))``.  This module reproduces that chain as JAX 0.9.0 runs
it with ``jax_threefry_partitionable=True`` (its default) and without
x64:

* :func:`key` — ``jax.random.key(seed)``: the raw key ``[hi, lo]`` of the
  seed.  Without x64 the seed is cut to its low 32 bits first, so the key
  is ``[0, seed mod 2**32]`` (``key(2**32 + 5)`` is ``[0, 5]``).
* :func:`fold_in` — ``threefry_2x32(key, [0, data])`` with ``data`` as
  uint32.
* :func:`random_bits` — 32-bit bits of a shape: the flat index split into
  a hi and a lo counter word, hashed, and the two output words xor-ed.
* :func:`normal` — f32 normals: the bits' top 23 as the mantissa of a
  float in [1, 2), minus 1, scaled to ``[nextafter(-1, 0), 1)`` and
  clamped below, then ``sqrt(2) * erfinv(u)``.  :func:`erfinv` is XLA's
  float32 polynomial (Giles' approximation, the one JAX lowers
  ``lax.erf_inv`` to), its log1p taken in float64 and each multiply-add
  rounded once: the normals agree with JAX's within 3 float32 ulp.
  (scipy's float64 ``erfinv`` rounded to float32 is the more exact
  function, but lies up to ~90 ulp from XLA's polynomial.)
* :func:`sketch_basis` — the QR of that Gaussian by numpy's LAPACK QR
  (Householder, float64, rounded to float32): the reference's column
  signs.

The uint32 bits equal JAX's bit for bit.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
# XLA's ErfInv32 coefficients, highest degree first, for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 block (20 rounds) of key ``(k1, k2)`` over the
    counter words ``x1``, ``x2`` (uint32 arrays of one shape)."""
    ks = (np.uint32(k1), np.uint32(k2),
          np.uint32(k1) ^ np.uint32(k2) ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x1, np.uint32) + ks[0],
             np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s raw data without x64: ``[0, seed mod
    2**32]``."""
    return np.array([0, int(seed) % 2**32], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)`` (``data`` taken as uint32)."""
    y1, y2 = threefry2x32(k[0], k[1], np.zeros(1, np.uint32),
                          np.array([int(data) % 2**32], np.uint32))
    return np.array([y1[0], y2[0]], np.uint32)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """32-bit random bits of ``shape`` (partitionable threefry)."""
    n = int(np.prod(shape, dtype=np.int64))
    flat = np.arange(n, dtype=np.uint64)
    hi = (flat >> np.uint64(32)).astype(np.uint32)
    lo = (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    y1, y2 = threefry2x32(k[0], k[1], hi, lo)
    return (y1 ^ y2).reshape(shape)


def uniform(k: np.ndarray, shape, lo: np.float32, hi: np.float32
            ) -> np.ndarray:
    """f32 uniforms in ``[lo, hi)`` as ``jax.random.uniform`` forms them."""
    bits = random_bits(k, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) \
        - np.float32(1.0)
    lo, hi = np.float32(lo), np.float32(hi)
    return np.maximum(lo, floats * (hi - lo) + lo)


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function on (-1, 1), XLA's polynomial: ``w =
    -log1p(-x^2)``, then a degree-8 polynomial in ``w - 2.5`` (w < 5) or
    ``sqrt(w) - 3``, times ``x``."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p((x * -x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(a), np.float32(b))
        # one rounding per multiply-add, as a fused multiply-add gives
        p = (c.astype(np.float64) + p.astype(np.float64)
             * w.astype(np.float64)).astype(np.float32)
    return p * x


def normal(k: np.ndarray, shape) -> np.ndarray:
    """f32 standard normals as ``jax.random.normal(k, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(k, shape, lo, np.float32(1.0))
    return np.float32(np.sqrt(2)) * erfinv(u)


def sketch_basis(seed: int, dim: int, idx: int, rnd: int, rank: int
                 ) -> np.ndarray:
    """The reference's orthonormal (dim, rank) sketch basis of leaf
    ``idx`` in round ``rnd``, float32."""
    g = normal(fold_in(fold_in(key(seed), idx), rnd), (dim, rank))
    q, _ = np.linalg.qr(g)
    return q.astype(np.float32)
