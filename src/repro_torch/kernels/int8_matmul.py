"""Weight-only int8 matmul: x (M,K) bf16|f32 · w_q (K,N) int8 → (M,N) x.dtype,
and its expert-batched form x (E,M,K) · w_q (E,K,N) → (E,M,N).

Replaces the TPU kernel `repro/kernels/int8_matmul.py::int8_matmul`, and
(`int8_matmul_batched`) the same kernel under `jax.vmap` over the expert dim
of the MoE projections (`repro/models/quantized.py:210-211`). The CUDA
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
  of one 64-row M tile leave SMs idle, and never below three K steps a
  split: a function of (K, N) only, so a row's output is bit-identical in
  a 64-row prefill chunk and in a 1024-row prefill bucket.

With more than one split, the splits run one of two ways, with the same
bits. **Split blocks** (the 2-D call): one block per (tile, split) writes
f32 partials to `(splits, M, N)` scratch allocated here and counts itself
done on its output tile's semaphore (`_build.semaphores`); the tile's last
block adds the partials in split-index order from +0.0 and applies the
scale, so the result does not depend on block timing. **Walking blocks**
(`batched_plan(...).walk`, a batched call whose experts' tiles already fill
the card): one block per tile takes its splits in index order, sums each
exactly as its split block does, and adds it to a running total that
starts at +0.0, which is the merge's order: no scratch, no semaphore, no
merge. One call is one kernel launch and counts as one in `LAUNCHES`,
whichever path, split and walk it took.

The batched call folds the expert into the grid (one launch for all E, no
loop over experts) and gives every expert `plan(M, K, N)`, the 2-D call's
plan: expert e's output is the 2-D kernel's output on (x[e], w_q[e],
scales[e]), bit for bit, walking or not. At qwen2-moe-a2.7b's experts
(E 60, K·N 2048 × 1408) one launch reads 173 MB of int8 weights: bound by
bytes. The 2-D plan splits K to fill 132 SMs from one expert; with 60
experts the tiles alone fill the card, so those launches walk (1,320 GEMV
blocks at M 8 where split blocks would be 15,840).

CPU tensors take `int8_matmul_ref` / `int8_matmul_batched_ref`; CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import int8_matmul_batched_ref, int8_matmul_ref

# launches of the CUDA kernel, keyed "M{m}xK{k}xN{n}" (2-D) and
# "E{e}xM{m}xK{k}xN{n}" (batched); only the wrappers on CUDA tensors add
# to it
LAUNCHES: Counter = Counter()

SMS = 132                 # streaming multiprocessors of an H100 SXM
GEMV_MAX_M = 16           # rows of one GEMV block (GV_MT in the source)
GEMV_BN = 64              # output columns of a GEMV block (GV_BN)
GEMV_KS_MAX = 256         # weight rows a GEMV block stages (GV_KS_MAX)
TC_TILE = 64              # BM = BN = BK of the tensor-core path
GEMV_WALK_MT = 8          # rows of a walking GEMV block at M <= 8
TC_WALK_BN = 128          # output columns of a walking tensor-core block

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"gemv": 0, "mma": 1}
_fn = None


class Plan(NamedTuple):
    path: str        # "gemv" (CUDA cores) or "mma" (tensor cores)
    ks: int          # rows of K per split
    splits: int      # ceil(K / ks); > 1 needs (splits, M, N) f32 scratch
    walk: bool = False   # one block walks a tile's splits: no scratch

    def tiles(self, m: int, n: int) -> int:
        """Output tiles of one expert: the blocks of one split, and the
        semaphores."""
        if self.path == "gemv":
            return _cdiv(m, GEMV_MAX_M) * _cdiv(n, GEMV_BN)
        return _cdiv(m, TC_TILE) * _cdiv(n, TC_TILE)

    def blocks(self, e: int, m: int, n: int) -> int:
        """Blocks of one launch over `e` experts: a block per tile and
        split, or a walking block per tile of its own (8 or 16 rows by 64
        columns on the GEMV path, 64 by 128 on the tensor cores)."""
        if not self.walk:
            return e * self.tiles(m, n) * self.splits
        if self.path == "gemv":
            rows = GEMV_WALK_MT if m <= GEMV_WALK_MT else GEMV_MAX_M
            return e * _cdiv(m, rows) * _cdiv(n, GEMV_BN)
        return e * _cdiv(m, TC_TILE) * _cdiv(n, TC_WALK_BN)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, k: int, n: int, dtype: torch.dtype) -> Plan:
    """The path and K split the kernel takes for x (m, k) of `dtype`.

    GEMV: splits of whole 16-row groups, at least 64 rows (or all of a
    shorter K), and as many as keep the grid within two blocks per SM (one
    wave). Tensor cores: whole 64-row K steps, at least three a split, as
    many splits as keep the grid of one 64-row M tile within one block per
    SM. Both are functions of (k, n) only, never of m: a row's sums do not
    depend on how many rows share the call. Both rules come from
    `tools/torch_int8_sweep.py` on the H100 (PERF.md §6): a split block
    costs its partial store, fence and count, and the last block reads
    every split back, so shorter splits read slower; a second wave costs
    more still. The batched call takes this plan for every expert
    (`batched_plan`), and where its experts fill the card its blocks walk
    the splits instead, which keeps these splits' bits and drops their
    costs."""
    if m <= GEMV_MAX_M or dtype == torch.float32:
        # a function of (k, n) only: the rows of x never change a row's sums
        splits = max(1, 2 * SMS // _cdiv(n, GEMV_BN))
        ks = min(GEMV_KS_MAX, max(_cdiv(min(k, 64), 16) * 16,
                                  _cdiv(_cdiv(k, splits), 16) * 16))
        return Plan("gemv", ks, _cdiv(k, ks))
    steps = _cdiv(k, TC_TILE)
    splits = max(1, min(SMS // _cdiv(n, TC_TILE), _cdiv(steps, 3)))
    ks = _cdiv(steps, splits) * TC_TILE
    return Plan("mma", ks, _cdiv(k, ks))


def batched_plan(e: int, m: int, k: int, n: int, dtype: torch.dtype) -> Plan:
    """`plan(m, k, n, dtype)` for each of `e` experts in one launch, and
    whether its blocks walk their splits. The path, `ks` and `splits` are
    the 2-D call's, and they alone set the bits; walking changes only the
    time. It walks when there is more than one expert and one split and
    the experts' output tiles alone fill the card (at least one block per
    SM): then the splits, cut to fill the card from one expert, buy no
    parallelism and cost a partial store, a fence, a count and a merge. A
    2-D call (e = 1) never walks."""
    p = plan(m, k, n, dtype)
    return p._replace(
        walk=e > 1 and p.splits > 1 and e * p.tiles(m, n) >= SMS)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("int8_matmul").int8_matmul_batched
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + \
            [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _run(name: str, key: str, x, w_q, scales, shapes) -> torch.Tensor:
    """x (E,M,K) · w_q (E,K,N) · scales (E,N) on the card: one launch of
    `batched_plan(E, M, K, N)` for every expert, counted in LAUNCHES[key].
    `shapes` are the caller's operand shapes, for the error messages."""
    e, m, k = x.shape
    e2, k2, n = w_q.shape
    if (e2, k2) != (e, k) or tuple(scales.shape) != (e, n):
        raise ValueError(f"{name} shapes {shapes}")
    if x.dtype not in _DTYPES or w_q.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        raise TypeError(f"{name} dtypes {x.dtype} {w_q.dtype} "
                        f"{scales.dtype}")
    for t in (x, w_q, scales):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} operands must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")
    out = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    if e == 0 or m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    p = batched_plan(e, m, k, n, x.dtype)
    part = sem = None
    if p.splits > 1 and not p.walk:
        sem = _build.semaphores(x.device, e * p.tiles(m, n))
        part = torch.empty((e, p.splits, m, n), dtype=torch.float32,
                           device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_kernel()(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                           out.data_ptr(), _ptr(part), _ptr(sem), e, m, n, k,
                           _DTYPES[x.dtype], _PATHS[p.path], p.ks, p.splits,
                           int(p.walk), stream),
                 name)
    LAUNCHES[key] += 1
    return out


def int8_matmul_cuda(x: torch.Tensor, w_q: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only; no fallback): the batched
    kernel with one expert."""
    shapes = (tuple(x.shape), tuple(w_q.shape), tuple(scales.shape))
    if x.dim() != 2 or w_q.dim() != 2 or scales.dim() != 1:
        raise ValueError(f"int8_matmul shapes {shapes}")
    key = f"M{x.shape[0]}xK{x.shape[1]}xN{w_q.shape[1]}"
    return _run("int8_matmul", key, x[None], w_q[None], scales[None],
                shapes)[0]


def int8_matmul_batched_cuda(x: torch.Tensor, w_q: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
    """Launch the expert-batched CUDA kernel (CUDA tensors only; no
    fallback): x (E,M,K), w_q (E,K,N) int8, scales (E,N) f32."""
    shapes = (tuple(x.shape), tuple(w_q.shape), tuple(scales.shape))
    if x.dim() != 3 or w_q.dim() != 3 or scales.dim() != 2:
        raise ValueError(f"int8_matmul_batched shapes {shapes}")
    e, m, k = x.shape
    key = f"E{e}xM{m}xK{k}xN{w_q.shape[2]}"
    return _run("int8_matmul_batched", key, x, w_q, scales, shapes)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """x (M,K) · w_q (K,N) int8 · scales (N,) f32 → (M,N) in x.dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_q, scales)
    return int8_matmul_cuda(x, w_q, scales)


def int8_matmul_batched(x: torch.Tensor, w_q: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """x (E,M,K) · w_q (E,K,N) int8 · scales (E,N) f32 → (E,M,N) in
    x.dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if x.device.type == "cpu":
        return int8_matmul_batched_ref(x, w_q, scales)
    return int8_matmul_batched_cuda(x, w_q, scales)
