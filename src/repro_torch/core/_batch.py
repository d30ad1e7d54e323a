"""Shape and reduction helpers of the batched simulator modules.

Per-design values carry the batch shape (...,); per-chiplet values carry
(..., n_chiplets). Sums over the chiplet axis add in index order, as the
reference's compiled reduction does, on every device (`torch.sum` is free
to pick another order on the card). Constant tensors a tick needs are made
once per device (`constant`): a host-to-device copy inside the tick loop
would wait for the card's queue every tick.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device


_CONSTANTS = {}


def constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """`torch.tensor(values, dtype, device)`, made once and kept; callers
    never write to it."""
    device = torch.device(device)
    key = (values, dtype, device)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return _CONSTANTS[key]


def flag(x, device) -> torch.Tensor:
    """A 0/1 switch (bool, number or tensor of per-design values) as bool."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.bool else x > 0.5
    return constant(bool(x), resolve_device(device), torch.bool)


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out
