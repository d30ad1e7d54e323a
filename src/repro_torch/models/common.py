"""Shared model substrate (port of `repro/models/common.py`): param schemas,
norms, activations, rotary embeddings, the depthwise causal conv of the
recurrent families.

Parameters are declared as a schema (nested dicts of `ParamDef`) and
materialised by `init_params` from an explicit `torch.Generator`, or by
`init_params_by_layer` one layer slice at a time (for trees that do not fit
the card twice). The distributions match the JAX package; the random
streams do not (tests bridge JAX-initialised weights through
`repro_torch.bridge` instead).
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


def _std(d: ParamDef) -> float:
    if d.init == "small_normal":
        return 0.02 * d.scale
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    return d.scale / math.sqrt(max(fan_in, 1))


def _draw(gen: torch.Generator, d: ParamDef, shape, dtype,
          device) -> torch.Tensor:
    """One draw of `shape` under `d`'s init (its std from `d`'s own shape)."""
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(_std(d)).to(dtype)     # in place: one f32 copy of the draw


def _init_one(gen: torch.Generator, d: ParamDef, dtype,
              device) -> torch.Tensor:
    return _draw(gen, d, d.shape, dtype, device)


def init_params(schema, gen: torch.Generator, dtype=torch.bfloat16,
                device=None):
    """Materialise a schema into a params dict of the same nesting. Leaves
    are drawn in sorted-key order from `gen`, which must live on `device`."""
    device = gen.device if device is None else device
    if isinstance(schema, ParamDef):
        return _init_one(gen, schema, dtype, device)
    return {k: init_params(schema[k], gen, dtype, device)
            for k in sorted(schema)}


def is_layer_stacked(d: ParamDef) -> bool:
    return d.logical[:1] == ("layers",)


def stack_slices(path, d: ParamDef, slices, dtype, device) -> torch.Tensor:
    """A layer-stacked leaf from its slices, in one tensor allocated once."""
    out = torch.empty(d.shape, dtype=dtype, device=device)
    for i, x in enumerate(slices):
        out[i] = x
    return out


def init_params_by_layer(schema, gen: torch.Generator, dtype=torch.bfloat16,
                         device=None, transform=None, build=None, _path=()):
    """`init_params` that draws a layer-stacked leaf (first logical axis
    "layers") one layer slice at a time, so no f32 temporary is larger than
    one layer's (a full-width qwen2.5-32b FFN leaf is 36 GB in f32, one
    layer 0.57 GB). Leaves are drawn in sorted-key order, each slice with
    the whole leaf's std; other leaves are drawn whole, as `init_params`
    draws them. A stream of its own: a leaf drawn by slices does not equal
    the same leaf drawn whole.

    `transform(path, x)` (path: the leaf's key tuple, e.g. ("layers", "wq"))
    maps each slice, or each whole leaf that is not layer-stacked, in the
    target dtype. `build(path, d, slices, dtype, device)` turns a
    layer-stacked leaf's slices (an iterator that draws as it is consumed)
    into its value; default `stack_slices`."""
    device = gen.device if device is None else device
    if not isinstance(schema, ParamDef):
        return {k: init_params_by_layer(schema[k], gen, dtype, device,
                                        transform, build, _path + (k,))
                for k in sorted(schema)}
    d = schema
    fix = (lambda x: transform(_path, x)) if transform else (lambda x: x)
    if not is_layer_stacked(d):
        return fix(_init_one(gen, d, dtype, device))
    slices = (fix(_draw(gen, d, d.shape[1:], dtype, device))
              for _ in range(d.shape[0]))
    return (build or stack_slices)(_path, d, slices, dtype, device)


# --------------------------------------------------------------------------
# Norms / activations
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in fp32 (mixed-precision-sensitive long reduction).

    Without autograd (serving) the mean of squares is summed in f64 and
    rounded to f32: the card's reduction kernel orders a row's sum by the
    number of rows beside it, and an f32 sum in another order can land an
    ulp apart, so one decode row normed alone (a one-slot engine) and in a
    batch of eight could differ. Every f32 square is exact in f64, and the
    f64 sum rounds to the same f32 in any order unless it lies within a few
    f64 ulps of an f32 rounding boundary. A graph that records gradients
    (training) sums in f32, as the reference does: a train step promises
    no row independent of its batch, and the f64 sum's casts cost it ~5 %
    of its device time."""
    xf = x.float()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        var = torch.mean(xf.double() ** 2, dim=-1, keepdim=True).float()
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


# --------------------------------------------------------------------------
# Depthwise causal conv1d (mamba2 / RG-LRU temporal conv)
# --------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal 1-D conv, f32 sums of K shifted products.

    x: (B, S, C); w: (K, C); `state` (B, K-1, C): the K-1 inputs before
    x[:, 0] (zeros when None). Returns (y in x's dtype, new state: the last
    K-1 inputs, in x's dtype) for streaming decode."""
    b, s, c = x.shape
    k = w.shape[0]
    pad = x.new_zeros((b, k - 1, c)) if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, S+K-1, C)
    xf, wf = xp.float(), w.float()
    y = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + xf[:, i:i + s] * wf[i]
    new_state = xp[:, s:] if k > 1 else x.new_zeros((b, 0, c))
    return y.to(x.dtype), new_state
