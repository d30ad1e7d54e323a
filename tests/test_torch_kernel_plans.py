"""The plain-Python planning of the port's redesigned CUDA kernels, on the
CPU: which path and K split `int8_matmul` takes, and how many splits the
split-KV decode kernel's grid and scratch have. The kernels themselves run
only on the card (tests/test_torch_kernels_cuda.py)."""

import pytest
import torch

from repro_torch.kernels import decode_attention as dmod
from repro_torch.kernels import int8_matmul as mmod

# every int8 projection of smollm-360m: (K, N)
SMOLLM_KN = [(960, 960), (960, 320), (960, 2560), (2560, 960)]


def _blocks(p, m, k, n):
    return p.tiles(m, n) * p.splits


@pytest.mark.parametrize("k,n", SMOLLM_KN + [(100, 33), (5, 7), (4096, 64)])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 70, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_plan_covers_k(m, k, n, dtype):
    """The splits tile K exactly: every split but the last is `ks` rows,
    the last is non-empty; GEMV splits are whole 16-row groups of at most
    GEMV_KS_MAX rows, tensor-core splits whole 64-row K steps."""
    p = mmod.plan(m, k, n, dtype)
    assert p.splits >= 1 and (p.splits - 1) * p.ks < k <= p.splits * p.ks
    if p.path == "gemv":
        assert p.ks % 16 == 0 and 16 <= p.ks <= mmod.GEMV_KS_MAX
    else:
        assert p.path == "mma" and p.ks % mmod.TC_TILE == 0


@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_plan_path(m, dtype):
    """GEMV at M <= 16 and for f32 x at any M (bf16 fragments would round
    x); tensor cores for bf16 x above 16 rows."""
    want = "gemv" if m <= mmod.GEMV_MAX_M or dtype == torch.float32 else "mma"
    assert mmod.plan(m, 960, 960, dtype).path == want


@pytest.mark.parametrize("k,n", SMOLLM_KN + [(100, 33)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_gemv_split_ignores_m(k, n, dtype):
    """The GEMV split is a function of (K, N) alone, which is what makes a
    row's output the same at M = 1 and M = 8 (and for f32 at any M)."""
    plans = {mmod.plan(m, k, n, dtype) for m in range(1, 17)}
    assert len(plans) == 1
    if dtype == torch.float32:
        assert mmod.plan(1000, k, n, dtype) in plans


@pytest.mark.parametrize("k,n", SMOLLM_KN)
@pytest.mark.parametrize("m", [8, 64])
def test_int8_matmul_plan_grid(m, k, n):
    """At the serve path's decode shapes the GEMV splits are at least 64
    rows and the grid is one wave of at most two blocks per SM (75 blocks
    at N = 320, 240 at N = 2560); at the chunk shapes the tensor-core grid has at least
    one block per SM's worth of splits within 132 blocks, and never below
    three K steps a split (N = 320: 5 tiles x 5 splits)."""
    p = mmod.plan(m, k, n, torch.bfloat16)
    blocks = _blocks(p, m, k, n)
    if p.path == "gemv":
        assert p.ks >= 64 and 64 <= blocks <= 2 * mmod.SMS
    else:
        assert 25 <= blocks <= mmod.SMS and p.ks >= 3 * mmod.TC_TILE


def test_int8_matmul_plan_splits_only_small_grids():
    """The tensor-core path splits K only while the output tiles alone
    leave SMs idle: M 1024 x N 2560 has 640 tiles and one split."""
    assert mmod.plan(1024, 960, 2560, torch.bfloat16).splits == 1
    assert mmod.plan(64, 960, 960, torch.bfloat16).splits > 1


@pytest.mark.parametrize("depth,want", [(0, 0), (1, 1), (256, 1), (257, 2),
                                        (1024, 4), (96, 1), (576, 3)])
def test_decode_attention_split_count(depth, want):
    """Splits of a fixed SPLIT = 256 keys over the cache's depth."""
    assert dmod.SPLIT == 256 and dmod.n_splits(depth) == want
