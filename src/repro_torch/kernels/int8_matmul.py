"""Weight-only int8 matmul: x (M,K) bf16|f32 · w_q (K,N) int8 → (M,N) x.dtype.

Replaces the TPU kernel `repro/kernels/int8_matmul.py::int8_matmul`. The CUDA
kernels are in `csrc/int8_matmul.cu`: f32 accumulation, per-output-channel
f32 scale in the epilogue, ragged M, N and K masked (no `blocks_fit`
contract: every smollm projection, K ∈ {960, 2560}, N ∈ {320, 960, 2560},
runs on them). `plan` chooses the path and the split of K from the shapes:

- **GEMV** (M ≤ 16, and f32 x at any M): CUDA-core FMAs over 64-column
  tiles, the weight read once as 16-byte `cp.async` copies. K is cut into
  splits whose length depends on (K, N) only (75–240 blocks at smollm's
  projections, at most two per SM), and a row's output is bit-identical
  whether it is computed alone or with seven other rows.
- **Tensor cores** (bf16 x, M > 16): 64×64 tiles of `mma.sync` m16n8k16
  bf16 products (int8 is exact in bf16), x and the int8 weight streamed by
  `cp.async` through a 4-stage ring. K is split only where the output tiles
  alone leave SMs idle, and never below three K steps a split.

With more than one split each block writes f32 partials to `(splits, M, N)`
scratch allocated here and counts itself done on its output tile's
semaphore (`_build.semaphores`); the tile's last block sums the partials in
split-index order and applies the scale, so the result does not depend on
block timing. One call is one kernel launch and counts as one in
`LAUNCHES`, whichever path and split it took.

CPU tensors take `int8_matmul_ref`; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import int8_matmul_ref

# launches of the CUDA kernel, keyed "M{m}xK{k}xN{n}"; only `int8_matmul`
# on CUDA tensors adds to it
LAUNCHES: Counter = Counter()

SMS = 132                 # streaming multiprocessors of an H100 SXM
GEMV_MAX_M = 16           # rows of one GEMV block (GV_MT in the source)
GEMV_BN = 64              # output columns of a GEMV block (GV_BN)
GEMV_KS_MAX = 256         # weight rows a GEMV block stages (GV_KS_MAX)
TC_TILE = 64              # BM = BN = BK of the tensor-core path

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"gemv": 0, "mma": 1}
_fn = None


class Plan(NamedTuple):
    path: str        # "gemv" (CUDA cores) or "mma" (tensor cores)
    ks: int          # rows of K per split
    splits: int      # ceil(K / ks); > 1 needs (splits, M, N) f32 scratch

    def tiles(self, m: int, n: int) -> int:
        """Output tiles: the blocks of one split, and the semaphores."""
        if self.path == "gemv":
            return _cdiv(m, GEMV_MAX_M) * _cdiv(n, GEMV_BN)
        return _cdiv(m, TC_TILE) * _cdiv(n, TC_TILE)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, k: int, n: int, dtype: torch.dtype) -> Plan:
    """The path and K split the kernel takes for x (m, k) of `dtype`.

    GEMV: splits of whole 16-row groups, at least 64 rows (or all of a
    shorter K), and as many as keep the grid within two blocks per SM (one
    wave): a function of (k, n) only. Tensor cores: whole 64-row K steps,
    at least three a split, as many splits as keep the grid within one
    block per SM. Both rules come from `tools/torch_int8_sweep.py` on the
    H100 (PERF.md §6): a split costs its block's partial store,
    fence and count, and the last block reads every split back, so shorter
    splits read slower; a second wave costs more still."""
    if m <= GEMV_MAX_M or dtype == torch.float32:
        # a function of (k, n) only: the rows of x never change a row's sums
        splits = max(1, 2 * SMS // _cdiv(n, GEMV_BN))
        ks = min(GEMV_KS_MAX, max(_cdiv(min(k, 64), 16) * 16,
                                  _cdiv(_cdiv(k, splits), 16) * 16))
        return Plan("gemv", ks, _cdiv(k, ks))
    tiles = _cdiv(m, TC_TILE) * _cdiv(n, TC_TILE)
    steps = _cdiv(k, TC_TILE)
    splits = max(1, min(SMS // tiles, _cdiv(steps, 3)))
    ks = _cdiv(steps, splits) * TC_TILE
    return Plan("mma", ks, _cdiv(k, ks))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("int8_matmul").int8_matmul
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
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
    if k == 0:
        return out.zero_()
    p = plan(m, k, n, x.dtype)
    part = sem = None
    if p.splits > 1:
        sem = _build.semaphores(x.device, p.tiles(m, n))
        part = torch.empty((p.splits, m, n), dtype=torch.float32,
                           device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_kernel()(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                           out.data_ptr(), _ptr(part), _ptr(sem), m, n, k,
                           _DTYPES[x.dtype], _PATHS[p.path], p.ks, p.splits,
                           stream),
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
