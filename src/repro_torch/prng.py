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
- `uniform` maps bits to [minval, maxval) through JAX's mantissa trick;
- `gumbel` is `mode="low"`: `-log(-log(uniform(tiny, 1)))`;
- `categorical` is Gumbel-argmax.

The integer part is exact: 32-bit lanes are held in int64 tensors and
masked to 32 bits after every add and shift. `log` may differ from XLA's
by an ulp, so a Gumbel score may too. Keys are (..., 2) int64 tensors of
32-bit words; every function runs on the device of its inputs and takes
a batch of keys along the leading axes.
"""

from __future__ import annotations

import torch

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


def uniform(k: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(k, (n,), float32, minval, maxval)`: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled, then
    clamped below at minval. (..., n) f32."""
    b = (bits(k, n) >> 9) | 0x3F800000
    f = b.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    span = (hi - lo).item()
    return torch.clamp(f * span + lo.item(), min=lo.item())


def gumbel(k: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.gumbel(k, (n,), float32)` in mode "low"."""
    return -torch.log(-torch.log(uniform(k, n, _F32_TINY, 1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(k, logits)` over the last axis:
    argmax(gumbel + logits), ties to the lowest index. (...,) int64."""
    return torch.argmax(gumbel(k, logits.shape[-1]) + logits, dim=-1)
