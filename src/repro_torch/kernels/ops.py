"""Any-shape wrappers around the block quantizers (port of
`repro/kernels/ops.py::quantize_blocks`/`dequantize_blocks`).

The JAX wrappers pad the flat size to whole (rows_per_tile × block) grid
tiles of the TPU kernel; this port pads the same way, so `q` and `s` have
the JAX shapes. CPU tensors take the plain versions, CUDA tensors the
kernels (`kernels/quantize.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import quantize as kq


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
