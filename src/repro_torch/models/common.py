"""Shared model substrate (port of `repro/models/common.py`): param schemas,
norms, activations, rotary embeddings.

Parameters are declared as a schema (nested dicts of `ParamDef`) and
materialised by `init_params` from an explicit `torch.Generator`. The
distributions match the JAX package; the random streams do not (tests bridge
JAX-initialised weights through `repro_torch.bridge` instead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declaration of one parameter tensor. `logical` names each dim (kept
    for parity with the JAX schema; this port shards nothing)."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | small_normal
    scale: float = 1.0         # fan-in scaling applied on top of init

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _init_one(gen: torch.Generator, d: ParamDef, dtype,
              device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / math.sqrt(max(fan_in, 1))
    if d.init == "small_normal":
        std = 0.02 * d.scale
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
    return (std * x).to(dtype)


def init_params(schema, gen: torch.Generator, dtype=torch.bfloat16,
                device=None):
    """Materialise a schema into a params dict of the same nesting. Leaves
    are drawn in sorted-key order from `gen`, which must live on `device`."""
    device = gen.device if device is None else device
    if isinstance(schema, ParamDef):
        return _init_one(gen, schema, dtype, device)
    return {k: init_params(schema[k], gen, dtype, device)
            for k in sorted(schema)}


# --------------------------------------------------------------------------
# Norms / activations
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in fp32 (mixed-precision-sensitive long reduction)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:  # gemma convention: weight is (1 + w)
        w = 1.0 + w
    return (y * w).to(x.dtype)


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def glu_act(name: str) -> str:
    """GLU family gate activation: swiglu→silu, geglu→gelu."""
    return {"swiglu": "silu", "geglu": "gelu"}[name]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Soft logit capping: cap*tanh(x/cap)."""
    if cap <= 0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension (fraction of head_dim)."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               fraction: float = 1.0, theta: float = 1e4) -> torch.Tensor:
    """RoPE over the final dim, interleaved (even, odd) pairs.

    x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S).
    fraction < 1 rotates only the leading `fraction` of head dims."""
    head_dim = x.shape[-1]
    inv = rope_frequencies(head_dim, fraction, theta, device=x.device)
    rot = inv.shape[0] * 2
    angles = positions[..., None].float() * inv          # (..., S, rot/2)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, rot/2)
    sin = torch.sin(angles)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2].float(), x_rot[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < head_dim else out
