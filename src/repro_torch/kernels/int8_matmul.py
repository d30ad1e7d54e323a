"""Weight-only int8 matmul: x (M,K) bf16|f32 · w_q (K,N) int8 → (M,N) x.dtype.

Replaces the TPU kernel `repro/kernels/int8_matmul.py::int8_matmul`. The CUDA
kernel is `csrc/int8_matmul.cu`: int8 upcast in registers, f32 accumulation,
per-output-channel f32 scale in the epilogue. On the serving path M is
n_slots (decode) or the prefill chunk, so it is bound by the bytes of the
int8 weight it reads once (K·N), not by operations. Ragged edges are masked in
the kernel, so there is no `blocks_fit` contract: every smollm projection
(K ∈ {960, 2560}, N ∈ {320, 960, 2560}) runs on it.

CPU tensors take `int8_matmul_ref`; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import int8_matmul_ref

# launches of the CUDA kernel, keyed "M{m}xK{k}xN{n}"; only `int8_matmul`
# on CUDA tensors adds to it
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("int8_matmul").int8_matmul
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def int8_matmul_cuda(x: torch.Tensor, w_q: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only; no fallback)."""
    m, k = x.shape
    k2, n = w_q.shape
    if k != k2 or scales.shape != (n,):
        raise ValueError(f"int8_matmul shapes {tuple(x.shape)} "
                         f"{tuple(w_q.shape)} {tuple(scales.shape)}")
    if x.dtype not in _DTYPES or w_q.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        raise TypeError(f"int8_matmul dtypes {x.dtype} {w_q.dtype} "
                        f"{scales.dtype}")
    for t in (x, w_q, scales):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("int8_matmul operands must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError("int8_matmul operands must be contiguous")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_kernel()(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                           out.data_ptr(), m, n, k, _DTYPES[x.dtype], stream),
                 "int8_matmul")
    LAUNCHES[f"M{m}xK{k}xN{n}"] += 1
    return out


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """x (M,K) · w_q (K,N) int8 · scales (N,) f32 → (M,N) in x.dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_q, scales)
    return int8_matmul_cuda(x, w_q, scales)
