"""JAX's threefry PRNG in torch integer arithmetic.

The reference samples a slot's i-th token with
`jax.random.categorical(jax.random.fold_in(jax.random.key(seed), i), logits)`
(`repro/serve/sampling.py`), under JAX's default `threefry2x32` key and
`jax_threefry_partitionable = True`. This module computes the same bits
in torch, so a seeded stream of the port equals the reference's:

- `key(seed)` is `threefry_seed`: a 32-bit seed becomes the key pair
  (0, seed mod 2**32);
- `fold_in(key, data)` is `threefry2x32(key, (0, data))`;
- `bits(key, n)` is the partitionable form: lane i hashes the 64-bit
  counter (0, i) and returns `t1 ^ t2`;
- `uniform` maps bits to [minval, maxval) through JAX's mantissa trick,
  any shape (the lanes of a shaped draw are its row-major flat index);
- `normal` is JAX's: `sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))`,
  with XLA's f32 `erfinv` polynomial;
- `gumbel` is `mode="low"`: `-log(-log(uniform(tiny, 1)))`;
- `categorical` is Gumbel-argmax.

The integer part is exact: 32-bit lanes are held in int64 tensors and
masked to 32 bits after every add and shift. `log` may differ from XLA's
by an ulp, so a Gumbel score may too; `log1p` likewise, so a normal
draw is within a few f32 ulps of JAX's. Keys are (..., 2) int64 tensors of
32-bit words; every function runs on the device of its inputs and takes
a batch of keys along the leading axes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.rounding import fma

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counter words (x1, x2) under key (k1, k2):
    20 rounds, a key injection after every 4. All arguments are int64
    tensors of 32-bit words, broadcast together; returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def key(seed, device=None) -> torch.Tensor:
    """`jax.random.key(seed)`'s key data for 32-bit seeds: (..., 2) int64
    words (0, seed mod 2**32). `seed` is an int or an integer tensor."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & _MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(k, data)`: hash the counter (0, data mod 2**32)
    under `k`. `data` broadcasts against k's leading axes."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _MASK
    d = torch.broadcast_to(d, k.shape[:-1])
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.bits(k, (n,))` (32-bit, partitionable): (..., n) int64
    words, lane i = t1 ^ t2 of threefry2x32(k, (0, i))."""
    iota = torch.arange(n, dtype=torch.int64, device=k.device)
    t1, t2 = threefry2x32(k[..., 0:1], k[..., 1:2], torch.zeros_like(iota),
                          iota)
    return t1 ^ t2


def uniform(k: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(k, shape, float32, minval, maxval)`: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, times the span plus
    minval in one rounding (XLA fuses that multiply-add), then clamped below
    at minval. `shape` is an int or a tuple; (..., *shape) f32."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    b = (bits(k, math.prod(shape)) >> 9) | 0x3F800000
    f = b.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    out = torch.clamp(fma(f, span, lo), min=lo)
    return out.reshape(*out.shape[:-1], *shape)


# XLA's f32 erfinv (Giles' polynomials in w = -log1p(-x^2), split at w = 5)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 `erf_inv`: the polynomial in Horner form with fused
    multiply-adds; +-1 map to +-inf. `torch.erfinv` is another algorithm
    that is up to ~6e-6 apart from it in relative terms."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        lo = torch.tensor(_ERFINV_LT5[i], dtype=torch.float32, device=x.device)
        hi = torch.tensor(_ERFINV_GE5[i], dtype=torch.float32, device=x.device)
        return torch.where(lt, lo, hi)

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.normal(k, shape, float32)`: (..., *shape) f32."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return float(np.float32(math.sqrt(2.0))) * erfinv(u)


def gumbel(k: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.gumbel(k, (n,), float32)` in mode "low"."""
    return -torch.log(-torch.log(uniform(k, n, _F32_TINY, 1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(k, logits)` over the last axis:
    argmax(gumbel + logits), ties to the lowest index. (...,) int64."""
    return torch.argmax(gumbel(k, logits.shape[-1]) + logits, dim=-1)
