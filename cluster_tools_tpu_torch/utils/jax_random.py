"""``jax.random.normal(jax.random.PRNGKey(seed), shape)`` in numpy, without
jax: the Threefry-2x32 counter hash, the uniform from its bits and the
normal transform, as jax computes them with ``jax_threefry_partitionable``
on (the default of jax 0.5 and later).

- the key of an integer seed is ``(0, seed mod 2^32)`` as two uint32
  words (jax without ``jax_enable_x64``, as the reference runs);
- the random bits of element ``i`` (row-major) are the Threefry-2x32 hash
  of the counter pair ``(i >> 32, i & 0xFFFFFFFF)``, its two output words
  XORed;
- a float32 uniform on ``[lo, hi)``: the top 23 bits as the mantissa of a
  float in ``[1, 2)``, less 1, times ``hi - lo``, plus ``lo``, then at least
  ``lo``;
- the normal: the uniform on ``(-1, 1)`` (``lo`` is the float after -1),
  then ``sqrt(2) * erfinv(u)``.

All three are jax's bit for bit on its CPU backend.  ``erfinv`` is the
float32 polynomial XLA uses (Giles' single-precision approximation) over
XLA's own float32 ``log1p`` (a Cephes rational function for small
arguments, else a Cephes ``logf`` of ``1 + x``), each evaluated in the
order and with the fused multiply-adds that XLA:CPU's code has on an x86
host with FMA: equal to jax's normal transform for every one of the 2^23
uniforms it can be given.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def seed_key(seed: int) -> np.ndarray:
    """The raw key of ``jax.random.PRNGKey(seed)`` with 32-bit integers:
    two uint32 words, the seed's low 32 bits in the second."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0,
    x1)`` under ``key``: two uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` as uint32 (partitionable mode)."""
    n = int(np.prod(shape, dtype=np.int64))
    counts = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (counts >> np.uint64(32)).astype(np.uint32),
                          (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = ((bits >> np.uint32(9)) | np.float32(1.0).view(np.uint32)).view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``a * b + c`` in float32 with one rounding: the product is exact in
    float64, the sum rounded to odd there, then once to float32."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    inexact_even = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(inexact_even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _f32(bits: int) -> np.float32:
    """The float32 whose float64 bit pattern is ``bits`` (how XLA's code
    spells its float32 constants)."""
    return np.float32(np.array([bits], np.uint64).view(np.float64)[0])


# log(1 + x) for |x| < sqrt(2) - 1: x - x^2 / 2 + x^3 * P(x) / Q(x)
_LOG1P_SMALL = _f32(0x3FDA8279A0000000)
_LOG1P_NUM = tuple(_f32(b) for b in (0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
                                      0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
                                      0x40340A2020000000))
_LOG1P_DEN = tuple(_f32(b) for b in (0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
                                      0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000))
# logf: the mantissa m in [sqrt(1/2), sqrt(2)), log(1 + f) for f = m - 1 as
# f - f^2 / 2 + f^3 * P(f), plus e * (ln 2 split in two)
_LOGF_SQRTHF = _f32(0x3FE6A09E60000000)
_LOGF_P = tuple(_f32(b) for b in (0x3FB2043760000000, 0xBFBD7A3700000000, 0xBFBFCBA9E0000000, 0x3FC23D37E0000000,
                                   0x3FC999D580000000, 0xBFCFFFFF80000000, 0x3FBDE4A340000000, 0xBFC555CA00000000,
                                   0x3FD5555540000000))
_LN2_LO, _LN2_HI = _f32(0xBF2BD01060000000), _f32(0x3FE6300000000000)
_FLT_MIN = _f32(0x3810000000000000)


def log1p_f32(x: np.ndarray) -> np.ndarray:
    """float32 ``log1p`` as XLA:CPU computes it (its ``xla.log1p.f32``,
    with the multiply-adds its x86 code fuses)."""
    x = np.asarray(x, np.float32)
    one, zero = np.float32(1.0), np.float32(0.0)
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        # large |x|: logf(1 + x)
        y = x + one
        bits = np.maximum(y, _FLT_MIN).view(np.uint32)
        e = ((bits >> np.uint32(23)).astype(np.int32) - 127).astype(np.float32) + one
        m = ((bits & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(np.float32)
        below = m < _LOGF_SQRTHF
        f = (m - one) + np.where(below, m, zero)
        e = e - np.where(below, one, zero)
        f2 = f * f
        f3 = f2 * f
        p = _LOGF_P
        q1 = _fma(_fma(f, p[0], p[1]), f, p[6])
        q2 = _fma(_fma(f, p[2], p[3]), f, p[7])
        q3 = _fma(_fma(f, p[4], p[5]), f, p[8])
        tail = _fma(_fma(_fma(q1, f3, q2), f3, q3), f3, e * _LN2_LO)
        large = _fma(e, _LN2_HI, (f - f2 * np.float32(0.5)) + tail)
        large = np.where(y == 0, np.float32(-np.inf), np.where(y == np.inf, y, np.where(y > 0, large, np.nan)))
        # small |x|: the rational function
        x2 = x * x
        num, den = _LOG1P_NUM[0], one
        for c in _LOG1P_NUM[1:]:
            num = _fma(num, x, c)
        for c in _LOG1P_DEN:
            den = _fma(den, x, c)
        small = x + _fma(x2, np.float32(-0.5), (x * x2) * (num / den))
        return np.where(np.abs(x) < _LOG1P_SMALL, small, large).astype(np.float32)


_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                   -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """float32 ``erfinv`` by XLA's polynomial: ``w = -log1p(-x * x)``, a
    degree-8 polynomial in ``w - 2.5`` (``w < 5``) or ``sqrt(w) - 3``,
    times ``x``; ``±inf`` at ``±1``."""
    x = np.asarray(x, np.float32)
    # at |x| = 1 the polynomial meets inf and nan; the edge case replaces it
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        w = -log1p_f32(x * -x)
        central = w < np.float32(5.0)
        t = np.where(central, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(central, np.float32(_ERFINV_CENTRAL[0]), np.float32(_ERFINV_TAIL[0]))
        for c_in, c_out in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
            p = _fma(p, t, np.where(central, np.float32(c_in), np.float32(c_out)))
        return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x).astype(np.float32)


def normal(seed: int, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape)`` (float32)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(seed_key(seed), shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)
