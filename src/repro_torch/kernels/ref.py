"""Plain PyTorch versions of every kernel (port of `repro/kernels/ref.py`).

These are the oracles the hand-written CUDA kernels are held to on the card
and the path the wrappers take for CPU tensors. None of them is a port of a
kernel."""

from __future__ import annotations

import torch


def int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """x (M,K) float; w_q (K,N) int8; scales (N,) f32 per-out-channel."""
    acc = x.float() @ w_q.float()
    return (acc * scales[None, :].float()).to(x.dtype)


def int8_matmul_batched_ref(x: torch.Tensor, w_q: torch.Tensor,
                            scales: torch.Tensor) -> torch.Tensor:
    """x (E,M,K) float; w_q (E,K,N) int8; scales (E,N) f32: per expert e,
    `int8_matmul_ref(x[e], w_q[e], scales[e])`."""
    acc = torch.bmm(x.float(), w_q.float())
    return (acc * scales[:, None, :].float()).to(x.dtype)


def quantize_channelwise_ref(w: torch.Tensor, axes):
    """Symmetric int8 over `axes` (the contraction dims), keepdims f32 scale.
    Rounding is half-to-even, as `jnp.round`."""
    wf = w.float()
    absmax = torch.amax(wf.abs(), dim=tuple(axes), keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight_ref(w: torch.Tensor):
    """Symmetric per-output-channel int8 weight quantization. w (K,N)."""
    q, scale = quantize_channelwise_ref(w, (0,))
    return q, scale[0]


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q/k/v: (B, H, S, D) → (B, H, S, D). fp32 softmax oracle."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sq, sk = q.shape[2], k.shape[2]
    diff = (torch.arange(sq, device=q.device)[:, None]
            - torch.arange(sk, device=q.device)[None, :])
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    s = torch.where(ok[None, None], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# 1/127 rounded to f32: XLA folds the reference's `absmax / 127.0` into a
# multiply by this reciprocal, so the scales are bit-identical to JAX's
INV127 = float(torch.tensor(1.0) / torch.tensor(127.0))


def quantize_blocks_ref(x: torch.Tensor, block: int = 256):
    """Flatten x, pad to a block multiple, symmetric per-block int8.

    scale = max(absmax, 1e-12) · f32(1/127); q = clip(round(x / scale),
    ±127) with an IEEE division and half-to-even rounding. A NaN in a block
    makes its scale NaN (`amax` propagates it) and its q undefined.
    Returns (q (n_blocks, block) int8, scales (n_blocks,) f32, orig_size)."""
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    absmax = torch.amax(blocks.abs(), dim=1)
    scale = torch.clamp(absmax, min=1e-12) * INV127
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale, n


def dequantize_blocks_ref(q: torch.Tensor, scales: torch.Tensor, n: int,
                          shape, dtype=torch.float32):
    flat = (q.float() * scales[:, None]).reshape(-1)[:n]
    return flat.reshape(shape).to(dtype)
