"""Blockwise symmetric int8 quantize / dequantize of (n_blocks, 256) tensors.

Replaces the TPU kernels `repro/kernels/quantize.py::quantize_blocks` and
`::dequantize_blocks`, which carry the error-feedback gradient compression
(`train/compression.py`) once per gradient leaf per step. The CUDA kernels
are `csrc/quantize_blocks.cu`: one warp per 256-element block for the
quantizer (shuffle absmax, 16-byte loads), one thread per 8 elements for the
dequantizer (16-byte stores). Both are bound by bytes and must equal their
plain versions (`quantize_blocks_ref` / `dequantize_blocks_ref`) bit for bit.

CPU tensors take the plain versions; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dequantize_blocks_ref, quantize_blocks_ref

BLOCK = 256   # the CUDA kernels' block width (one warp, 8 values per lane)

# launches of the CUDA kernels, keyed "quantize_blocks" / "dequantize_blocks";
# only the *_cuda wrappers add to it
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def _kernel(name: str):
    f = _fns.get(name)
    if f is None:
        f = getattr(_build.load("quantize_blocks"), name)
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns[name] = f
    return f


def _check_operand(t: torch.Tensor, device: torch.device, what: str) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{what} operands must share one CUDA device")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} operands must be contiguous and 16-byte "
                         "aligned")


def quantize_blocks_cuda(x2d: torch.Tensor):
    """Launch the CUDA quantizer (CUDA tensors only; no fallback).
    x2d (n_blocks, 256) f32|bf16 → (q (n_blocks, 256) int8, scales f32)."""
    if x2d.dim() != 2 or x2d.shape[1] != BLOCK:
        raise ValueError(f"quantize_blocks takes (n_blocks, {BLOCK}), got "
                         f"{tuple(x2d.shape)}")
    if x2d.dtype not in _DTYPES:
        raise TypeError(f"quantize_blocks input dtype {x2d.dtype}")
    _check_operand(x2d, x2d.device, "quantize_blocks")
    nb = x2d.shape[0]
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x2d.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=x2d.device)
    if nb == 0:
        return q, scales
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    _build.check(_kernel("quantize_blocks")(
        x2d.data_ptr(), q.data_ptr(), scales.data_ptr(), nb,
        _DTYPES[x2d.dtype], stream), "quantize_blocks")
    LAUNCHES["quantize_blocks"] += 1
    return q, scales


def dequantize_blocks_cuda(q: torch.Tensor, scales: torch.Tensor,
                           out_dtype=torch.float32) -> torch.Tensor:
    """Launch the CUDA dequantizer (CUDA tensors only; no fallback).
    q (n_blocks, 256) int8, scales (n_blocks,) f32 → (n_blocks, 256)
    `out_dtype` (f32 or bf16)."""
    if q.dim() != 2 or q.shape[1] != BLOCK or scales.shape != (q.shape[0],):
        raise ValueError(f"dequantize_blocks shapes {tuple(q.shape)} "
                         f"{tuple(scales.shape)}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or out_dtype not in _DTYPES:
        raise TypeError(f"dequantize_blocks dtypes {q.dtype} {scales.dtype} "
                        f"→ {out_dtype}")
    for t in (q, scales):
        _check_operand(t, q.device, "dequantize_blocks")
    nb = q.shape[0]
    out = torch.empty((nb, BLOCK), dtype=out_dtype, device=q.device)
    if nb == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(_kernel("dequantize_blocks")(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), nb,
        _DTYPES[out_dtype], stream), "dequantize_blocks")
    LAUNCHES["dequantize_blocks"] += 1
    return out


def quantize_blocks(x2d: torch.Tensor):
    """x2d (n_blocks, block) → (int8 blocks, f32 scales). CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if x2d.device.type == "cpu":
        q, s, _ = quantize_blocks_ref(x2d, block=x2d.shape[1])
        return q, s
    return quantize_blocks_cuda(x2d)


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      out_dtype=torch.float32) -> torch.Tensor:
    """(int8 blocks, f32 scales) → (n_blocks, block) `out_dtype`. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return dequantize_blocks_ref(q, scales, q.numel(), q.shape, out_dtype)
    return dequantize_blocks_cuda(q, scales, out_dtype)
