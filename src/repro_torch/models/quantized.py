"""Weight-only int8 pass, quantization-aware einsum and int8 KV rows (port of
`repro/models/quantized.py`, dense family).

Quantized leaves are plain dicts `{"int8_q": int8, "s": f32}`; `s` keeps the
weight's rank with contraction dims reduced to 1. `qeinsum` sends float
weights to `torch.einsum` and quantized ones through the port's
`int8_matmul` (the CUDA kernel on CUDA tensors, its plain version on CPU
ones) after reshaping to 2-D exactly as the JAX `_try_pallas` does. There is
no `blocks_fit` gate: the kernel masks ragged tiles itself.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.ref import quantize_channelwise_ref

_QKEY = "int8_q"

# param key → contraction axes of the layer-stacked weight (axis 0 = layers)
_ATTN_AXES = {"wq": (1,), "wk": (1,), "wv": (1,), "wo": (1, 2)}
_FFN_AXES = {"w1": (1,), "w3": (1,), "w2": (1,)}

SCALE_DTYPE = torch.float16   # int8 KV scale storage (one per row, kv head)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and _QKEY in w


def quantize_weight_channelwise(w: torch.Tensor, axes: Tuple[int, ...]
                                ) -> Dict[str, torch.Tensor]:
    q, s = quantize_channelwise_ref(w, axes)
    return {_QKEY: q, "s": s}


def quantize_params(params, cfg):
    """Weight-only int8 over the dense family's layer QKV/O + FFN weights;
    embeddings, norms and the LM head stay as they are."""
    if cfg.family != "dense" or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"int8 weights for family {cfg.family!r}/{cfg.attn_kind!r} come "
            "with ROADMAP A10 (remaining model families)")
    table = dict(_ATTN_AXES, **_FFN_AXES)
    layers = {k: (quantize_weight_channelwise(v, table[k]) if k in table
                  else v)
              for k, v in params["layers"].items()}
    return dict(params, layers=layers)


def _parse(eq: str):
    lhs, out = eq.replace(" ", "").split("->")
    xs, ws = lhs.split(",")
    contract = [c for c in ws if c not in out]
    batch = [c for c in ws if c in xs and c in out]
    wout = [c for c in ws if c in out and c not in batch]
    return xs, ws, out, "".join(contract), "".join(batch), "".join(wout)


def qeinsum(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """`torch.einsum(eq, x, w)` where `w` may be a quantized `{int8_q, s}`
    leaf. Handled pattern (every dense projection): x = <x-out><contract>,
    w = <contract><w-out>, out = <x-out><w-out>."""
    if not is_quantized(w):
        return torch.einsum(eq, x, w)
    q, s = w[_QKEY], w["s"]
    xs, ws, out, c, b, wout = _parse(eq)
    x_out = xs[:len(xs) - len(c)]
    if b or not c or not xs.endswith(c) or ws != c + wout \
            or out != x_out + wout:
        raise NotImplementedError(
            f"qeinsum pattern {eq!r} (batched/expert weights come with "
            "ROADMAP A10)")
    m = 1
    for d in x.shape[:len(x_out)]:
        m *= d
    k = x.numel() // max(m, 1)
    n = q.numel() // k
    # the keepdims scale has 1s on the contraction dims and the weight's
    # output dims in order, so a flat view is already in output-dim order
    y = int8_matmul(x.reshape(m, k).contiguous(), q.reshape(k, n),
                    s.reshape(n).float().contiguous())
    return y.reshape(*x.shape[:len(x_out)], *q.shape[len(c):])


def quantize_kv_rows(kv: torch.Tensor):
    """(..., D) K/V rows → (int8 rows, f16 per-row scale (...,)).

    Per-token-per-head symmetric int8 over the head dim. The scale is rounded
    to f16 BEFORE the divide, so `q * s` reconstructs within s/2 whichever
    layout stored the bytes; rounding is half-to-even, as `jnp.round`."""
    kvf = kv.float()
    absmax = torch.amax(kvf.abs(), dim=-1)
    s = torch.clamp(absmax / 127.0, min=1e-6).to(SCALE_DTYPE)
    q = torch.clamp(torch.round(kvf / s.float()[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv_rows(q: torch.Tensor, s: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    return (q.float() * s.float()[..., None]).to(dtype)
