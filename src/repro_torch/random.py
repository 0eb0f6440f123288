"""Counter-based random numbers equal to ``jax.random``'s, bit for bit.

The threefry2x32 hash with ``jax_threefry_partitionable`` on (the default
of jax 0.5 and later): keys are ``(2,)`` tensors of two 32-bit words,
``split`` and ``random_bits`` hash a 64-bit iota split into its high and
low words. Words are held in int64 tensors masked to 32 bits, which every
device computes the same way (torch has no full uint32 arithmetic).

``uniform``, ``gumbel`` (jax's default ``"low"`` mode) and ``categorical``
follow ``jax._src.random`` step for step, so ``generate`` at a temperature
draws the JAX package's tokens from the same seed. Two float steps are
taken as XLA's CPU backend computes them, so the values are equal too: the
scale-and-shift of ``uniform`` is one fused multiply-add, and ``log`` is
the Cephes polynomial XLA emits, with its fused multiply-adds. A fused
multiply-add is computed in float64 and rounded once to float32.
"""
from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 hash of the word pairs ``(x1, x2)`` under the key
    ``(k1, k2)``: 20 rounds in five groups of four, each group followed by
    a key injection (``jax._src.prng._threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed, as ``jax.random.PRNGKey`` without x64:
    the seed taken as a signed 32-bit integer, whose high word is 0."""
    lo = int(seed) & _MASK
    return torch.tensor([0, lo], dtype=torch.int64, device=device)


def _iota_2x32(shape, device):
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def _hash_iota(key: torch.Tensor, shape):
    hi, lo = _iota_2x32(tuple(shape), key.device)
    return threefry2x32(key[0], key[1], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys, ``(num, 2)``, as ``jax.random.split``."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 holding a uint32)."""
    b1, b2 = _hash_iota(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 in ``[minval, maxval)``: the top 23 bits as the mantissa of
    a float in ``[1, 2)``, less one, scaled and shifted, floored at
    ``minval`` (``jax._src.random._uniform``)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, _fma(floats, (hi - lo).double(), lo))


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (the product is exact in
    float64)."""
    return (a.double() * b + c).float()


def _f32(*vals) -> tuple:
    return tuple(torch.tensor(vals, dtype=torch.float32).tolist())


# Cephes' log(1 + x) polynomial on [sqrt(1/2) - 1, sqrt(2) - 1], and ln 2
# split into a short high part and a correction, as float32 constants
_LOG_P = _f32(7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
              -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
              2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4, 0.693359375)


def log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float32 values as XLA's CPU backend
    computes it: the mantissa brought to ``[sqrt(1/2), sqrt(2))`` less one,
    the polynomial in three interleaved fused multiply-add chains, the
    exponent's ln 2 added in two parts."""
    m, e = torch.frexp(x)
    low = m < 0.707106781186547524
    e = e.float() - low.float()
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    return (x - x2 * 0.5 + y) + e * _LOG_Q2


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard Gumbel float32 samples, jax's ``"low"`` mode:
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    tiny = torch.finfo(torch.float32).tiny
    return -log(-log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """A draw from ``softmax(logits)`` along ``axis`` by the Gumbel-max
    trick, as ``jax.random.categorical`` (with replacement, one sample per
    row; the lower index on ties). Returns int64 indices."""
    g = gumbel(key, logits.shape).to(logits.dtype)
    return torch.argmax(g + logits, dim=axis)
