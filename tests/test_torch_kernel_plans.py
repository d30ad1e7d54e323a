"""The plain-Python planning of the port's redesigned CUDA kernels, on the
CPU: which path and K split `int8_matmul` takes, how many splits the
split-KV decode kernel's grid and scratch have, and which path, row tiles,
key splits, grid and scratch the two prefill attention kernels take. The
kernels themselves run only on the card (tests/test_torch_kernels_cuda.py)."""

import pytest
import torch

from repro_torch.kernels import decode_attention as dmod
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import int8_matmul as mmod

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

# every int8 projection of smollm-360m: (K, N)
SMOLLM_KN = [(960, 960), (960, 320), (960, 2560), (2560, 960)]
# qwen2-moe-a2.7b's: attention, shared expert, routed experts (w1/w3, w2)
QWEN_MOE_KN = [(2048, 2048), (2048, 5632), (5632, 2048), (2048, 1408),
               (1408, 2048)]
# qwen2.5-32b's: wq/wo (5120 = 40 x 128), wk/wv (8 x 128), w1/w3, w2
QWEN32_KN = [(5120, 5120), (5120, 1024), (5120, 27648), (27648, 5120)]


def _blocks(p, m, k, n):
    return p.tiles(m, n) * p.splits


@pytest.mark.parametrize("k,n", SMOLLM_KN + QWEN32_KN
                         + [(100, 33), (5, 7), (4096, 64)])
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


@pytest.mark.parametrize("k,n", SMOLLM_KN + QWEN32_KN + [(100, 33)])
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
    """The tensor-core path splits K only while the output tiles of one
    64-row M tile leave SMs idle: N 960 has 15 such tiles and 5 splits of
    3 K steps, N 2560 has 40 and 3 splits, and N 8448 (132 tiles) one
    split, whatever M is."""
    for m in (64, 1024):
        assert mmod.plan(m, 960, 960, torch.bfloat16).splits == 5
        assert mmod.plan(m, 960, 2560, torch.bfloat16).splits == 3
        assert mmod.plan(m, 960, 8448, torch.bfloat16).splits == 1


@pytest.mark.parametrize("k,n", SMOLLM_KN + QWEN_MOE_KN + QWEN32_KN
                         + [(100, 33)])
def test_int8_matmul_mma_split_ignores_m(k, n):
    """The tensor-core split is a function of (K, N) alone, as the GEMV
    split is: a row's output is the same in a 64-row chunk and in a 512-
    or 1024-row prefill bucket."""
    plans = {mmod.plan(m, k, n, torch.bfloat16)
             for m in (17, 64, 96, 512, 658, 1024, 4096)}
    assert len(plans) == 1 and plans.pop().path == "mma"


@pytest.mark.parametrize("depth,want", [(0, 0), (1, 1), (256, 1), (257, 2),
                                        (1024, 4), (96, 1), (576, 3)])
def test_decode_attention_split_count(depth, want):
    """Splits of a fixed SPLIT = 256 keys over the cache's depth."""
    assert dmod.SPLIT == 256 and dmod.n_splits(depth) == want


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "mma"),
                                        (torch.float32, "cuda_core")])
def test_attention_plans_path(dtype, want):
    """bf16 q takes the tensor cores in both prefill kernels; f32 q keeps
    the CUDA-core f32 body (bf16 fragments would round it beyond 1e-4)."""
    assert fmod.chunk_plan(64, 3, 1024, dtype).path == want
    assert fmod.dense_plan(15, 1024, 1024, dtype).path == want


# (q_offset, kv_len, C, G, window): the serve chunks (a middle chunk, the
# ragged last chunk of a 741-token prompt, the first chunk), spans across
# split edges, a one-row chunk, windows, and no live key at all
CHUNK_SPANS = [(384, 448, 64, 3, 0), (704, 741, 64, 3, 0), (0, 64, 64, 3, 0),
               (200, 300, 64, 3, 0), (480, 520, 64, 3, 0),
               (200, 300, 64, 3, 40), (480, 520, 64, 8, 100),
               (96, 130, 64, 1, 20), (127, 128, 1, 3, 0), (0, 0, 64, 3, 0),
               (30, 31, 64, 2, 0), (1000, 1024, 24, 5, 0)]


@pytest.mark.parametrize("off,live,c,g,window", CHUNK_SPANS)
def test_chunk_splits_tile_the_live_keys(off, live, c, g, window):
    """Each row tile's live splits cover its keys [lo, hi) exactly, each
    split once and in order, at the absolute edges k·SPLIT; every row's
    own keys lie in its tile's range, and a row run alone as a one-row
    chunk at q_offset + i gets splits with the same edges, a subset of its
    tile's: the split length depends on no batch, chunk or row."""
    plan = fmod.chunk_plan(c, g, 1024, torch.bfloat16)
    assert fmod.SPLIT == 128
    for tile in range(plan.row_tiles):
        lo, hi = fmod.row_tile_keys(off, live, c, g, window, tile)
        splits = fmod.live_splits(lo, hi)
        covered = []
        for sp in splits:
            assert 0 <= sp < plan.splits
            covered += range(max(lo, sp * fmod.SPLIT),
                             min(hi, (sp + 1) * fmod.SPLIT))
        assert covered == list(range(lo, hi))
        rows = range(tile * fmod.ROW_TILE, min(c * g, (tile + 1) * fmod.ROW_TILE))
        for r in rows:
            i = r // g
            rlo, rhi = fmod.row_tile_keys(off + i, live, 1, g, window, 0)
            assert rlo >= lo and (rhi <= hi or rhi <= rlo)
            assert set(fmod.live_splits(rlo, rhi)) <= set(splits)


def test_chunk_plan_at_the_serving_shapes():
    """smollm-360m's chunk (C 64, KV 5, G 3, D 64) against a 1024-row pool:
    three row tiles of 64 packed rows, eight 128-key splits, a grid of
    8 x 3 x 5 blocks of which the middle chunk (384, 448) runs 4 x 3 x 5,
    and (m, l, acc) scratch for every row of every split."""
    plan = fmod.chunk_plan(64, 3, 1024, torch.bfloat16)
    assert (plan.row_tiles, plan.splits) == (3, 8)
    assert plan.grid(1, 5, 64) == (8, 3, 5)
    live = sum(len(fmod.live_splits(*fmod.row_tile_keys(384, 448, 64, 3, 0, t)))
               for t in range(plan.row_tiles)) * 5
    assert live == 60
    assert plan.scratch_floats(1, 5) == 5 * 3 * 8 * 64 * 66
    assert plan.semaphores(1, 5) == 15
    f32 = fmod.chunk_plan(64, 3, 1024, torch.float32)
    assert f32.grid(1, 5, 64) == (5, 16) and f32.scratch_floats(1, 5) == 0


@pytest.mark.parametrize("s,tiles", [(1024, 16), (658, 11), (512, 8), (1, 1)])
def test_dense_plan_grid(s, tiles):
    """Tensor cores: one block per (128-key split, 64 rows, batch·head),
    8 x 16 x 15 blocks at the timed (1, 15, 1024, 64), with (m, l, acc)
    scratch for every row of every split and a semaphore per row tile;
    CUDA cores: (S / 16, B·H) and no scratch."""
    plan = fmod.dense_plan(15, s, s, torch.bfloat16)
    splits = -(-s // fmod.SPLIT)
    assert plan.grid == (splits, tiles, 15) and plan.splits == splits
    assert plan.scratch_floats() == splits * tiles * 15 * 64 * 66
    assert plan.semaphores() == tiles * 15
    f32 = fmod.dense_plan(15, s, s, torch.float32)
    assert f32.grid == (-(-s // 16), 15) and f32.scratch_floats() == 0


@pytest.mark.parametrize("m", [1, 8, 64, 512, 1024])
@pytest.mark.parametrize("k,n", QWEN32_KN)
def test_int8_matmul_plan_at_qwen2_5_32b(m, k, n):
    """qwen2.5-32b's four (K, N) on the serve path's M: GEMV at the decode
    rows (M 1, 8) in 256-row K splits (20 of them at K 5120, 108 at the
    27648-row w2, at least 80 output tiles: a block an SM or more), the
    tensor cores at the chunk and bucket rows with a split that depends on
    (K, N) alone (wk/wv's N 1024 has 16 tiles a 64-row M tile and splits K
    8 ways; the wider ones do not split)."""
    p = mmod.plan(m, k, n, torch.bfloat16)
    if m <= mmod.GEMV_MAX_M:
        assert (p.path, p.ks, p.splits) == ("gemv", 256, -(-k // 256))
        assert p.tiles(m, n) * p.splits >= mmod.SMS
    else:
        assert p.path == "mma"
        assert p.splits == (8 if n == 1024 else 1)
        assert p == mmod.plan(64, k, n, torch.bfloat16)


def test_attention_plans_at_qwen2_5_32b():
    """qwen2.5-32b's attention (40 query heads on 8 KV heads of 128: G 5)
    takes the narrow paths: decode one block a (256-key split, sequence ·
    KV head) for all 5 heads; a 64-row chunk packs 320 rows into 5 row
    tiles over eight 128-key splits (grid 8 x 5 x 8 at one sequence) with
    a semaphore a row tile; dense flash at (1, 40, 1024, 128) 8 x 16 x 40
    blocks."""
    dp = dmod.decode_plan(5, 128, 128, 1024)
    assert (dp.path, dp.splits, dp.groups) == ("narrow", 4, 1)
    assert dp.semaphores(8, 8) == 64
    cp = fmod.chunk_plan(64, 5, 1024, torch.bfloat16, 128, 128)
    assert (cp.path, cp.row_tiles, cp.splits, cp.dv) == ("mma", 5, 8, 128)
    assert cp.grid(1, 8, 64) == (8, 5, 8)
    assert cp.scratch_floats(1, 8) == 8 * 5 * 8 * 64 * 130
    assert cp.semaphores(1, 8) == 40
    fp = fmod.dense_plan(40, 1024, 1024, torch.bfloat16, 128)
    assert (fp.path, fp.grid, fp.splits) == ("mma", (8, 16, 40), 8)
    assert fp.semaphores() == 16 * 40


@pytest.mark.parametrize("s", [64, 658, 1024])
def test_dense_plan_cuts_rows_as_the_chunk_plan(s):
    """A dense causal row tile's live splits are the chunk kernel's for a
    chunk of the same 64 rows at the same offset with G = 1 (the dense
    kernel's row tiles and splits lie at the same absolute positions), so
    a row is summed in the same 128-key groups by both kernels."""
    dense = fmod.dense_plan(1, s, s, torch.bfloat16)
    for tile in range(dense.grid[1]):
        row0 = tile * fmod.ROW_TILE
        rows = min(fmod.ROW_TILE, s - row0)
        chunk = fmod.row_tile_keys(row0, s, rows, 1, 0, 0)
        assert chunk == (0, row0 + rows)
        assert max(fmod.live_splits(*chunk)) < dense.splits


@pytest.mark.parametrize("sq,sk", [(64, 4096), (256, 4096), (37, 4096),
                                   (658, 4096), (300, 77), (4096, 4096)])
@pytest.mark.parametrize("d", [64, 256])
def test_dense_plan_takes_other_key_counts(sq, sk, d):
    """Sq != Sk (cross attention, unmasked): the splits come from the Sk
    keys and the row tiles from the Sq rows, so every row tile of every
    call over the same keys runs the same SPLIT-key splits, whatever Sq:
    seamless-m4t-medium's 64-row chunk over its 4096 encoder rows is one
    row tile over 32 splits (grid 32 x 1 x 16), its prompt's 256-row
    bucket four row tiles over the same 32."""
    p = fmod.dense_plan(16, sq, sk, torch.bfloat16, d)
    tiles, splits = -(-sq // fmod.ROW_TILE), -(-sk // fmod.SPLIT)
    assert p.splits == splits == fmod.dense_plan(16, 1, sk, torch.bfloat16,
                                                 d).splits
    assert p.grid == ((16, tiles) if d > 128 else (splits, tiles, 16))
    assert p.scratch_floats() == splits * tiles * 16 * 64 * (d + 2)
    f32 = fmod.dense_plan(16, sq, sk, torch.float32, 64)
    assert f32.grid == (-(-sq // 16), 16) and f32.splits == 0
    if (sq, sk, d) == (64, 4096, 64):
        assert p.grid == (32, 1, 16) and p.semaphores() == 16


def _capture_launch(monkeypatch, e, m, k, n):
    """Run the wrapper's launch on zero CPU tensors with the kernel, the
    stream and the semaphores stubbed out (no kernel runs); returns the
    semaphore requests and the kernel's arguments."""
    import types
    calls = []
    monkeypatch.setattr(mmod._build, "semaphores",
                        lambda dev, count: calls.append(count) or
                        torch.zeros(count, dtype=torch.int32))
    monkeypatch.setattr(mmod, "_kernel",
                        lambda: (lambda *a: calls.append(a) or 0))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    monkeypatch.setattr(mmod, "LAUNCHES", type(mmod.LAUNCHES)())
    mmod._run("int8_matmul_batched", "key",
              torch.zeros(e, m, k, dtype=torch.bfloat16),
              torch.zeros(e, k, n, dtype=torch.int8), torch.zeros(e, n), ())
    assert mmod.LAUNCHES == {"key": 1}
    return calls[:-1], calls[-1]


@pytest.mark.parametrize("m", [8, 64, 96])
@pytest.mark.parametrize("k,n", QWEN_MOE_KN[3:] + [(100, 33)])
def test_int8_matmul_batched_plan_is_the_2d_plan(m, k, n, monkeypatch):
    """The expert-batched kernel gives every expert `plan(m, k, n)`, the 2-D
    call's plan, in one launch: qwen2-moe's experts at the decode (M 64: 8
    groups x capacity 8), chunk (M 8) and monolithic-bucket (M 96) shapes.
    Their 60 experts' tiles fill the card, so the launch walks: it passes
    the 2-D path, `ks` and `splits` with the walk flag and asks for no
    semaphores and no scratch. The ragged (100, 33) has one tile an
    expert (60 blocks) and keeps split blocks with their semaphores. The
    launch is captured on the CPU (no kernel runs)."""
    e = 60
    p = mmod.plan(m, k, n, torch.bfloat16)
    assert p.path == ("gemv" if m <= mmod.GEMV_MAX_M else "mma")
    bp = mmod.batched_plan(e, m, k, n, torch.bfloat16)
    assert bp[:3] == p[:3] and not p.walk
    assert bp.walk == ((k, n) in QWEN_MOE_KN)
    sems, args = _capture_launch(monkeypatch, e, m, k, n)
    assert args[6:10] == (e, m, n, k)
    assert args[11:15] == (mmod._PATHS[p.path], p.ks, p.splits, int(bp.walk))
    if bp.walk:
        assert p.splits > 1 and sems == [] and args[4:6] == (None, None)
        assert e * p.tiles(m, n) >= mmod.SMS
        # one walking block a tile: 8 x 64 (GEMV, M 8), 64 x 128 (mma)
        walking_tiles = (-(-n // 64) if m <= 8 else -(-m // 64) * -(-n // 128))
        assert bp.blocks(e, m, n) == e * walking_tiles
        assert bp.blocks(e, m, n) < p.blocks(e, m, n) // 3
    else:
        assert sems == ([e * p.tiles(m, n)] if p.splits > 1 else [])
        assert (args[4] is None) == (p.splits == 1)


@pytest.mark.parametrize("m", [1, 8, 64, 96, 1024])
@pytest.mark.parametrize("k,n", SMOLLM_KN + QWEN_MOE_KN + [(100, 33)])
def test_int8_matmul_2d_launch_never_walks(m, k, n, monkeypatch):
    """E = 1 (the 2-D call) never walks: its launch passes `plan(m, k, n)`
    with the walk flag 0, and with more than one split it asks for one
    semaphore per output tile and passes scratch, as before the walking
    kernels existed."""
    p = mmod.plan(m, k, n, torch.bfloat16)
    assert mmod.batched_plan(1, m, k, n, torch.bfloat16) == p
    sems, args = _capture_launch(monkeypatch, 1, m, k, n)
    assert args[6:15] == (1, m, n, k, mmod._DTYPES[torch.bfloat16],
                          mmod._PATHS[p.path], p.ks, p.splits, 0)
    assert sems == ([p.tiles(m, n)] if p.splits > 1 else [])
    assert (args[4] is None) == (args[5] is None) == (p.splits == 1)


# B7's shapes: (G, head_dim, value width) of chatglm3-6b, gemma-7b,
# recurrentgemma-2b, G 16 at head_dim 256, and MLA latent rows
WIDE = [(16, 128, 128), (1, 256, 256), (10, 256, 256), (16, 256, 256),
        (16, 576, 512)]


@pytest.mark.parametrize("g,d,dv", [(3, 64, 64), (8, 128, 128), (1, 32, 32),
                                    (5, 128, 128)]
                         + WIDE + [(9, 128, 128), (8, 160, 160)])
def test_decode_plan_paths(g, d, dv):
    """The narrow decode path takes up to 8 heads and head_dim 128; more
    heads, wider heads and latent rows take the wide path. Either way one
    block per (split, sequence, kv head) holds every head (one group), with
    one semaphore a (sequence, kv head); the split is SPLIT = 256 keys."""
    p = dmod.decode_plan(g, d, dv, 1024)
    narrow = g <= 8 and d <= 128 and dv == d
    assert p.path == ("narrow" if narrow else "wide")
    assert p.splits == 4 and dmod.SPLIT == 256
    assert p.groups == 1
    assert p.semaphores(8, 2) == 16


@pytest.mark.parametrize("g,d,dv", WIDE)
def test_chunk_plan_wide_rows(g, d, dv):
    """bf16 q at head_dim above 128 or latent rows: the wide tensor-core
    path, 8-warp blocks over ROW_TILE packed rows as the narrow path's
    row tiles, each block accumulating all dv value columns: the grid is
    (splits, row tiles, B·KV) with no slab dimension, the scratch holds dv
    columns a row and there is one semaphore a row tile. f32 q stays on
    the CUDA cores."""
    p = fmod.chunk_plan(64, g, 1024, torch.bfloat16, d, dv)
    wide = not (d <= 128 and dv == d)
    assert (p.path, p.dv, p.warps) == (("wide", dv, 8) if wide
                                       else ("mma", d, 4))
    assert p.row_tiles == -(-64 * g // fmod.ROW_TILE) and p.splits == 8
    assert p.grid(1, 2, 64) == (8, p.row_tiles, 2)
    assert p.scratch_floats(1, 2) == \
        2 * p.row_tiles * 8 * fmod.ROW_TILE * (dv + 2)
    assert p.semaphores(1, 2) == 2 * p.row_tiles
    assert fmod.chunk_plan(64, g, 1024, torch.float32, d, dv).path == \
        "cuda_core"


# (name, C, G, head_dim, value width, pool depth, B, KV): the chunk and
# decode shapes `chip_smoke.py` times for gemma-7b, chatglm3-6b and the
# latent rows of deepseek-v2-lite (8 slots, a 1024-row pool)
SERVE_WIDE = [("gemma-7b", 64, 1, 256, 256, 1024, 8, 16),
              ("chatglm3-6b", 64, 16, 128, 128, 1024, 8, 2),
              ("latent", 64, 16, 576, 512, 1024, 8, 1)]


@pytest.mark.parametrize("name,c,g,d,dv,depth,b,kv", SERVE_WIDE)
def test_wide_scratch_and_semaphores_at_the_serving_shapes(
        name, c, g, d, dv, depth, b, kv):
    """The scratch and semaphores the wrappers allocate at the served wide
    shapes: chunk attention one (m, l, acc[dv]) record a packed row of a
    split and one semaphore a (sequence, kv head, row tile) (gemma-7b: one
    row tile of 64 rows, chatglm3-6b and latent rows 16); decode one record
    a (sequence, kv head, split, head) and one semaphore a (sequence, kv
    head), whatever the group."""
    cp = fmod.chunk_plan(c, g, depth, torch.bfloat16, d, dv)
    tiles = {"gemma-7b": 1, "chatglm3-6b": 16, "latent": 16}[name]
    assert cp.path == ("mma" if name == "chatglm3-6b" else "wide")
    assert (cp.row_tiles, cp.splits) == (tiles, 8)
    assert cp.grid(1, kv, c) == (8, tiles, kv)
    assert cp.scratch_floats(1, kv) == kv * tiles * 8 * 64 * (dv + 2)
    assert cp.semaphores(1, kv) == kv * tiles
    dp = dmod.decode_plan(g, d, dv, depth)
    assert (dp.path, dp.splits, dp.groups) == ("wide", 4, 1)
    assert dp.semaphores(b, kv) == b * kv


@pytest.mark.parametrize("d", [32, 64, 96, 128, 160, 192, 224, 256])
def test_dense_plan_every_head_dim(d):
    """Dense flash attention takes every head_dim a multiple of 32 up to
    256 in bf16, each block accumulating the whole row (no slab dimension
    in the grid): up to 128 a 4-warp block a (split, row tile, batch·head)
    with a semaphore a row tile; above it an 8-warp block a (batch·head,
    row tile) that walks its splits, no semaphores. Both keep (m, l, acc)
    scratch for every row of every split."""
    assert d in fmod.DENSE_HEAD_DIMS
    p = fmod.dense_plan(16, 1024, 1024, torch.bfloat16, d)
    wide = d > 128
    assert p.path == ("wide" if wide else "mma")
    assert p.warps == (8 if wide else 4) and p.splits == 8 and p.dv == d
    assert p.grid == ((16, 16) if wide else (8, 16, 16))
    assert fmod.dense_plan(15, 1024, 1024, torch.bfloat16, d).grid[:2] == \
        ((15, 16) if wide else (8, 16))
    assert p.scratch_floats() == 8 * 16 * 16 * 64 * (d + 2)
    assert p.semaphores() == (0 if wide else 16 * 16)


def _stub_launch(monkeypatch, mod, getter):
    """Stub `mod`'s kernel, the stream, the semaphores and `is_cuda`, so a
    wrapper's launch runs on CPU tensors; returns the list the kernel's
    arguments and the semaphore requests land in."""
    import types
    calls = []
    monkeypatch.setattr(mod._build, "semaphores",
                        lambda dev, count: calls.append(("sem", count)) or
                        torch.zeros(max(count, 1), dtype=torch.int32))
    monkeypatch.setattr(mod, getter, lambda: (lambda *a: calls.append(a) or 0))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    return calls


@pytest.mark.parametrize("latent", [False, True])
@pytest.mark.parametrize("cdt", [torch.float32, torch.float8_e5m2])
def test_decode_wrapper_launch_arguments(latent, cdt, monkeypatch):
    """The decode wrapper on CPU tensors with the kernel stubbed: latent
    rows (one pool as k and v, v_dim 512) give a (B, 1, KV, G, 512) output
    and scratch rows of 512 + 2, the wide path flag and one semaphore a
    (sequence, kv head) for all 16 heads; an e5m2 cache passes dtype code
    3."""
    calls = _stub_launch(monkeypatch, dmod, "_kernel")
    monkeypatch.setattr(dmod, "LAUNCHES", type(dmod.LAUNCHES)())
    b, g = 2, 16
    d, vd = (576, 512) if latent else (128, None)
    pool = torch.zeros(5, 32, 1, d).to(cdt)
    q = torch.zeros(b, 1, 1, g, d, dtype=torch.bfloat16)
    table = torch.ones(b, 2, dtype=torch.int32)
    out = dmod.decode_attention_cuda(q, pool, pool, torch.ones(b),
                                     page_table=table, v_dim=vd)
    assert out.shape == (b, 1, 1, g, vd or d)
    (_, sems), args = calls
    assert sems == b                           # one kv head, one group
    assert args[10:15] == (b, 1, g, d, vd or d)
    assert args[-5:-1] == (1, dmod._QDT[q.dtype], dmod._KVDT[cdt], 1)
    key = "fp8" if cdt == torch.float8_e5m2 else "f32"
    assert dmod.LAUNCHES == {f"paged/{key}": 1}


@pytest.mark.parametrize("d,vd", [(256, None), (576, 512)])
def test_chunk_wrapper_launch_arguments(d, vd, monkeypatch):
    """The chunk wrapper on CPU tensors with the kernel stubbed: head_dim
    256 and latent rows take path 2 (wide) with (D, DV) passed and the
    scratch and semaphores of `chunk_plan` (one a row tile); f32 q at G 16
    and an
    fp8 pool are refused before any launch."""
    calls = _stub_launch(monkeypatch, fmod, "_kernel")
    monkeypatch.setattr(fmod, "LAUNCHES", type(fmod.LAUNCHES)())
    g, c = 16, 64
    pool = torch.zeros(5, 32, 1, d, dtype=torch.bfloat16)
    q = torch.zeros(1, c, 1, g, d, dtype=torch.bfloat16)
    table = torch.ones(1, 4, dtype=torch.int32)
    qo, kl = torch.zeros(1), torch.full((1,), 64)
    out = fmod.flash_attention_paged_cuda(q, pool, pool, table, qo, kl,
                                          v_dim=vd)
    dv = vd or d
    assert out.shape == (1, c, 1, g, dv)
    plan = fmod.chunk_plan(c, g, 128, torch.bfloat16, d, dv)
    (_, sems), args = calls
    assert sems == plan.semaphores(1, 1) == plan.row_tiles == 16
    assert args[11:17] == (1, c, 1, g, d, dv)
    assert args[-3:-1] == (fmod._PATHS["wide"], plan.splits)
    assert fmod.LAUNCHES == {"bf16": 1}
    with pytest.raises(ValueError):
        fmod.flash_attention_paged_cuda(q.float(), pool, pool, table, qo, kl,
                                        v_dim=vd)
    with pytest.raises(TypeError):
        fp8 = pool.to(torch.float8_e5m2)
        fmod.flash_attention_paged_cuda(q, fp8, fp8, table, qo, kl, v_dim=vd)
