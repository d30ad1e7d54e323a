"""Public kernel entry points (port of `repro/kernels/ops.py`).

`flash_attention` is dense attention of (B, H, Sq, D) queries over (B, H,
Sk, D) keys (Sq != Sk unmasked only); `quantize_blocks`/
`dequantize_blocks` are the any-shape wrappers around the block quantizers.
The JAX wrappers pad the quantizers' flat size to whole (rows_per_tile ×
block) grid tiles of the TPU kernel; this port pads the same way, so `q` and
`s` have the JAX shapes. CPU tensors take the plain versions, CUDA tensors
the kernels (`kernels/flash_attention.py`, `kernels/quantize.py`); a kernel
that fails to build or launch raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import quantize as kq
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None, block_q: int = 128, block_k: int = 128):
    """q (B, H, Sq, D), k/v (B, H, Sk, D) → (B, H, Sq, D), causal and/or
    windowed (Sq == Sk), or unmasked.

    `block_q`/`block_k` are the TPU kernel's tiling and are accepted for
    the JAX signature only: the CUDA kernel picks its own tiles (bf16: 64
    query rows by 64 keys on the tensor cores; f32: 16 rows by 32 keys on
    the CUDA cores, `kernels.flash_attention.dense_plan`) and takes any
    S."""
    del block_q, block_k
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                scale=scale)


def quantize_blocks(x: torch.Tensor, block: int = 256, rows_per_tile: int = 8):
    """Any-shape tensor → (int8 blocks (n_blocks, block), f32 scales
    (n_blocks,), orig_size). Pads the flat size to a multiple of
    block × rows_per_tile with zeros."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % (block * rows_per_tile)
    if pad:
        flat = F.pad(flat, (0, pad))
    q, s = kq.quantize_blocks(flat.reshape(-1, block).contiguous())
    return q, s, n


def dequantize_blocks(q: torch.Tensor, s: torch.Tensor, n: int, shape,
                      dtype=torch.float32) -> torch.Tensor:
    """Inverse of `quantize_blocks`: the first n values, reshaped."""
    flat = kq.dequantize_blocks(q, s, dtype).reshape(-1)
    return flat[:n].reshape(shape)
