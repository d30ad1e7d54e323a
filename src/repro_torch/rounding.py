"""f32 arithmetic rounded the way the reference's compiled code rounds it.

XLA's CPU backend, compiling the reference's jitted functions, contracts
`a * b + c` into one fused multiply-add, turns `x / const` into
`x * (1 / const)`, folds a chain of products by constants,
`x * c1 * c2`, into `x * (c1 * c2)`, and divides `a / b / c` as
`a / (b * c)`. The port's eager torch ops round each product and each
sum, and CUDA's `x / python_scalar` multiplies by the reciprocal while the
CPU divides. Code that must equal the reference bit for bit, on the card and
on the CPU alike, spells both forms out with these helpers.
"""

from __future__ import annotations

import numpy as np
import torch


def fma(a, b, c) -> torch.Tensor:
    """f32 `a * b + c` rounded once. The product of two f32 values is exact in
    f64 and the sum rounds there first, so the result is the fused one except
    where that f64 sum lands exactly on an f32 rounding midpoint (29 bits
    must match; the two roundings then differ by one f32 ulp). Scalars are
    taken as f32 values."""
    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.double()
        return float(np.float32(x))
    out = f64(a) * f64(b)
    out = out + f64(c)
    return out.float()


def recip(c: float) -> float:
    """The f32 reciprocal of the f32 value of `c`, as XLA folds `x / c`."""
    return float(np.float32(1.0) / np.float32(c))


def const(*factors: float) -> float:
    """The product of constants folded as XLA folds `x * c1 * c2 ...`: each
    factor taken as f32, multiplied left to right in f32."""
    out = np.float32(factors[0])
    for f in factors[1:]:
        out = np.float32(out * np.float32(f))
    return float(out)
