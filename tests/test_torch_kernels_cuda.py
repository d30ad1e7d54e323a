"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card: every decode-attention variant (kv_len on the 256-key split
edges and windows across them too), chunk-prefill attention (float and int8
pools, windows, no live rows), dense flash attention (the JAX kernel tests'
shape matrix, the serve shapes with a ragged S, windows, f32 and bf16),
int8_matmul over ragged shapes on both its paths (M 1 to 1024) and the
gradient block quantizers (bit for bit), plus the launch counters and the
wrappers' refusals. Chunk attention runs at the decode tests' (KV, G, D)
matrix and on spans across its 128-key split edges. Four properties of the
split and tiled designs hold bit for bit: an int8_matmul row at M = 1
equals the same row at M = 8, and a row at M = 64 equals it inside M = 512
and M = 1024; a sequence decoded alone equals it decoded in a batch of 8,
paged and dense alike; a chunk row equals the same row run alone as a
one-row chunk; the first 658 rows of causal dense attention at S = 1024
equal a run at S = 658; and a row of causal dense attention at S = 1024
equals the chunk kernel's row over the same K/V in a pool (f32, bf16 and
int8 pools); unmasked, with Sq != Sk (cross attention), a row of a 64-row
call equals the same row of a 256-row call. The expert-batched
int8_matmul holds each expert's slice to
the 2-D kernel on that slice, bit for bit, and to its plain version, at
E 6 and at qwen2-moe's E 60, where its blocks walk their K splits.
The shapes beyond 8 query heads a kv head and head_dim 128 (`WIDE_SHAPES`:
chatglm3-6b's G 16, gemma-7b's head_dim 256, 10 and 16 heads of 256) and
MLA latent rows (16 heads on one pool, keys 576 wide, values its first 512
columns) run every kernel against its plain version, decode alone equals
decode in a batch there too, dense flash rows equal chunk rows, an MLA
monolithic prefill's rows equal chunked prefill's, and e5m2 caches decode;
the wide paths also hold at their split, tile and warp edges;
bf16 projections run in fixed row blocks, so a row equals itself at any M.

Marked `cuda`: a CUDA kernel has no CPU mode, so these skip without a GPU.
Run them on a machine with an H100:
    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances: f32 outputs `atol=1e-4` (summation order, expf); bf16 outputs
`atol=2**-6` (one bf16 ulp at |o| < 4); unmasked attention over thousands
of unit-normal keys, whose outputs average down to |o| ~ 0.03, either of
them times max |o| (`_out_tol`). The peaky-score tests give q and k
the std that smollm-360m's schema init gives them at full width (about 8
and 14: scores near 100, a near-one-hot softmax) and hold f32 q to 1e-4.
Their q and K are integer-valued (an int8 pool holds 2K with scale 0.5), so
every score is exact in f32 in any summation order and the tests see the
kernels' softmax and PV alone: with non-integer values the f32 rounding of
scores near 100 moves both versions by ~1e-4."""

import pytest
import torch

from repro_torch.kernels import decode_attention as dmod
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import int8_matmul as mmod
from repro_torch.kernels.ref import int8_matmul_ref, quantize_weight_ref
from repro_torch.models.quantized import quantize_kv_rows

pytestmark = pytest.mark.cuda

SCHEMA_QK_STD = (8.0, 13.7)
# qwen2.5-32b at full width: 40 query heads on 8 KV heads of 128 (G 5), and
# its int8 projections' (K, N): wq/wo, wk/wv, w1/w3, w2
QWEN32_HEADS = (8, 5, 128)
QWEN32_KN = [(5120, 5120), (5120, 1024), (5120, 27648), (27648, 5120)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2 ** -6


def _out_tol(dtype, want):
    """`_tol` at the scale of the outputs where they are small (unmasked
    attention over thousands of unit-normal keys: |o| ~ 0.03)."""
    return _tol(dtype) * min(1.0, want.float().abs().max().item())


def _peaky(gen, q_shape, n_pages, ps, kv, d, dtype):
    """Integer-valued q and K at the schema init's std, random V."""
    q = (torch.randn(*q_shape, generator=gen, device="cuda")
         * SCHEMA_QK_STD[0]).round()
    k = torch.randn(n_pages, ps, kv, d, generator=gen, device="cuda")
    v = torch.randn(n_pages, ps, kv, d, generator=gen, device="cuda")
    if dtype == torch.int8:
        kq = (k * 2 * SCHEMA_QK_STD[1]).round().clamp(-127, 127).to(torch.int8)
        vq, vs = quantize_kv_rows(v)
        half = torch.full(k.shape[:-1], 0.5, dtype=torch.float16, device="cuda")
        return q, kq, vq, half, vs
    k = (k * SCHEMA_QK_STD[1]).round().clamp(-127, 127)
    return q, k.to(dtype), v.to(dtype), None, None


def _pools(gen, n_pages, ps, kv, d, dtype):
    k = torch.randn(n_pages, ps, kv, d, generator=gen, device="cuda")
    v = torch.randn(n_pages, ps, kv, d, generator=gen, device="cuda")
    if dtype == torch.int8:
        (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
        return kq, vq, ks, vs
    return k.to(dtype), v.to(dtype), None, None


# (batch, page size, pages per sequence, kv_len): "ragged" is empty, 1,
# ragged and past the cache's depth in one 256-key split; "split_edges"
# puts kv_len at 1 and on either side of the split edges 256 and 512 (with
# window 40, the live range of 257 and 513 crosses an edge)
DECODE_LENS = {"ragged": (4, 16, 6, [0, 1, 47, 16 * 6 + 3]),
               "split_edges": (6, 32, 18, [1, 255, 256, 257, 512, 513])}


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("kv,g,d", [(5, 3, 64), (2, 8, 128), (1, 1, 32),
                                    QWEN32_HEADS])
@pytest.mark.parametrize("lens", ["ragged", "split_edges"])
def test_decode_attention_matches_plain(gen, paged, qdt, cdt, window, kv, g, d,
                                        lens):
    b, ps, pps, kv_lens = DECODE_LENS[lens]
    n_pages = 1 + b * pps
    pk, pv, ks, vs = _pools(gen, n_pages, ps, kv, d, cdt)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(b, pps).to(torch.int32).contiguous()
    q = torch.randn(b, 1, kv, g, d, generator=gen, device="cuda").to(qdt)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    if not paged:
        idx = table.long()
        pk, pv = (p[idx].reshape(b, -1, kv, d).contiguous() for p in (pk, pv))
        if ks is not None:
            ks, vs = (s[idx].reshape(b, -1, kv).contiguous() for s in (ks, vs))
        table = None
    kw = dict(page_table=table, k_scale=ks, v_scale=vs, window=window)
    before = sum(dmod.LAUNCHES.values())
    got = dmod.decode_attention_cuda(q, pk, pv, kv_len, **kw)
    want = dmod.decode_attention_plain(q, pk, pv, kv_len, **kw)
    torch.cuda.synchronize()
    assert sum(dmod.LAUNCHES.values()) == before + 1
    assert got.dtype == qdt and got.shape == q.shape
    assert torch.all(got[kv_len == 0] == 0)
    assert (got.float() - want.float()).abs().max().item() <= _tol(qdt)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_decode_attention_cross_cache_matches_plain(gen, qdt, cdt):
    """The encoder-decoder's cross read: one query row a slot over a dense
    (8, 4096, 16, 64) cache of encoder rows, G 1, kv_len 4096 for every
    slot (seamless-m4t-medium at full width, 8 slots)."""
    b, s, kv, d = 8, 4096, 16, 64
    k, v = (torch.randn(b, s, kv, d, generator=gen, device="cuda").to(cdt)
            for _ in "kv")
    q = torch.randn(b, 1, kv, 1, d, generator=gen, device="cuda").to(qdt)
    kv_len = torch.full((b,), s, dtype=torch.int32, device="cuda")
    got = dmod.decode_attention_cuda(q, k, v, kv_len)
    want = dmod.decode_attention_plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert dmod.decode_plan(1, d, d, s).path == "narrow"
    assert (got.float() - want.float()).abs().max().item() <= _out_tol(qdt,
                                                                       want)


# (q_offset, kv_len): the first chunk, a ragged span, no live key, one key;
# then spans across the chunk kernel's 128-key split edges (256, 512)
CHUNK_SPANS = [(0, 64), (96, 130), (0, 0), (30, 31), (200, 300), (480, 520)]


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("span", CHUNK_SPANS)
@pytest.mark.parametrize("kv,g,d", [(5, 3, 64), (2, 8, 128), (1, 1, 32),
                                    QWEN32_HEADS])
def test_chunk_attention_matches_plain(gen, qdt, pdt, window, span, kv, g, d):
    ps, pps, C = 32, 32, 64
    n_pages = 1 + 2 * pps
    pk, pv, ks, vs = _pools(gen, n_pages, ps, kv, d, pdt)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm[:pps].reshape(1, pps).to(torch.int32).contiguous()
    q = torch.randn(1, C, kv, g, d, generator=gen, device="cuda").to(qdt)
    off, live = span
    qo = torch.tensor([off], dtype=torch.int32, device="cuda")
    kl = torch.tensor([live], dtype=torch.int32, device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, window=window)
    before = sum(fmod.LAUNCHES.values())
    got = fmod.flash_attention_paged_cuda(q, pk, pv, table, qo, kl, **kw)
    want = fmod.flash_attention_paged_plain(q, pk, pv, table, qo, kl, **kw)
    torch.cuda.synchronize()
    assert sum(fmod.LAUNCHES.values()) == before + 1
    assert (got.float() - want.float()).abs().max().item() <= _tol(qdt)
    if live == 0:
        assert torch.all(got == 0)


@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("span,window", [((384, 448), 0), ((704, 741), 0),
                                         ((200, 300), 40), ((480, 520), 100)])
@pytest.mark.parametrize("kv,g,d", [(5, 3, 64), QWEN32_HEADS])
def test_chunk_row_alone_equals_row_in_chunk(gen, pdt, span, window, kv, g,
                                             d):
    """Tensor-core path (bf16 q): tiles and splits at absolute key
    positions, so each row of a 64-row chunk equals, bit for bit, the same
    row run alone as a one-row chunk at q_offset + i (smollm-360m's and
    qwen2.5-32b's heads)."""
    ps, pps, C = 32, 32, 64
    n_pages = 1 + pps
    pk, pv, ks, vs = _pools(gen, n_pages, ps, kv, d, pdt)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(1, pps).to(torch.int32).contiguous()
    q = torch.randn(1, C, kv, g, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    off, live = span
    kl = torch.tensor([live], dtype=torch.int32, device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, window=window)
    full = fmod.flash_attention_paged_cuda(
        q, pk, pv, table, torch.tensor([off], dtype=torch.int32, device="cuda"),
        kl, **kw)
    for i in range(C):
        qo = torch.tensor([off + i], dtype=torch.int32, device="cuda")
        alone = fmod.flash_attention_paged_cuda(
            q[:, i:i + 1].contiguous(), pk, pv, table, qo, kl, **kw)
        assert torch.equal(_bits(alone[:, 0]), _bits(full[:, i])), f"row {i}"


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16, torch.int8])
def test_decode_attention_peaky_scores_match_plain(gen, paged, cdt):
    b, kv, g, d, ps, pps = 8, 5, 3, 64, 32, 32
    n_pages = 1 + b * pps
    q, pk, pv, ks, vs = _peaky(gen, (b, 1, kv, g, d), n_pages, ps, kv, d, cdt)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(b, pps).to(torch.int32).contiguous()
    kv_len = torch.tensor([674, 517, 424, 246, 274, 78, 103, 1024],
                          dtype=torch.int32, device="cuda")
    if not paged:
        idx = table.long()
        pk, pv = (p[idx].reshape(b, -1, kv, d).contiguous() for p in (pk, pv))
        if ks is not None:
            ks, vs = (s[idx].reshape(b, -1, kv).contiguous() for s in (ks, vs))
        table = None
    kw = dict(page_table=table, k_scale=ks, v_scale=vs)
    got = dmod.decode_attention_cuda(q, pk, pv, kv_len, **kw)
    want = dmod.decode_attention_plain(q, pk, pv, kv_len, **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("span", [(0, 64), (384, 448), (704, 741)])
def test_chunk_attention_peaky_scores_match_plain(gen, pdt, span):
    kv, g, d, ps, pps, C = 5, 3, 64, 32, 32, 64
    n_pages = 1 + pps
    q, pk, pv, ks, vs = _peaky(gen, (1, C, kv, g, d), n_pages, ps, kv, d, pdt)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(1, pps).to(torch.int32).contiguous()
    off, live = span
    qo = torch.tensor([off], dtype=torch.int32, device="cuda")
    kl = torch.tensor([live], dtype=torch.int32, device="cuda")
    kw = dict(k_scale=ks, v_scale=vs)
    got = fmod.flash_attention_paged_cuda(q, pk, pv, table, qo, kl, **kw)
    want = fmod.flash_attention_paged_plain(q, pk, pv, table, qo, kl, **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


# dense flash attention: tests/test_kernels.py's matrix, then smollm-360m's
# monolithic prefill shapes (15 heads, head_dim 64) with a ragged S = 658
FLASH_SHAPES = [(1, 2, 256, 64), (2, 1, 512, 128), (1, 4, 384, 64),
                (1, 15, 512, 64), (1, 15, 1024, 64), (1, 15, 658, 64)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(gen, shape, causal, dtype):
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    key = ("f32" if dtype == torch.float32 else "bf16") + (
        "" if causal else "/unmasked")
    before = fmod.DENSE_LAUNCHES[key]
    got = fmod.flash_attention_cuda(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fmod.DENSE_LAUNCHES[key] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype)


@pytest.mark.parametrize("window", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [512, 658])
def test_flash_attention_window_matches_plain(gen, window, causal, s):
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = (torch.randn(1, 2, s, 64, generator=gen, device="cuda")
               for _ in range(3))
    got = fmod.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("s", [512, 658, 1024])
def test_flash_attention_peaky_scores_match_plain(gen, s):
    """q and k integer-valued at the schema init's std (scores near 100,
    exact in f32 at head_dim 64): the kernel's softmax and PV alone."""
    from repro_torch.kernels.ref import flash_attention_ref
    q = (torch.randn(1, 15, s, 64, generator=gen, device="cuda")
         * SCHEMA_QK_STD[0]).round()
    k = (torch.randn(1, 15, s, 64, generator=gen, device="cuda")
         * SCHEMA_QK_STD[1]).round().clamp(-127, 127)
    v = torch.randn(1, 15, s, 64, generator=gen, device="cuda")
    got = fmod.flash_attention_cuda(q, k, v)
    want = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_prefix_equals_shorter_run(gen, dtype):
    """Causal dense attention with tiles at absolute key positions: the
    first 658 rows at S = 1024 equal a run at S = 658 on the same prefix,
    bit for bit (658 is ragged: its tail tile is zero-filled and masked)."""
    q, k, v = (torch.randn(1, 15, 1024, 64, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    full = fmod.flash_attention_cuda(q, k, v)
    short = fmod.flash_attention_cuda(
        *(t[:, :, :658].contiguous() for t in (q, k, v)))
    assert torch.equal(_bits(short), _bits(full[:, :, :658]))


def test_flash_attention_counts_and_refusals(gen):
    """One launch per call keyed by dtype, through `ops` and the model's
    dispatcher; shapes the kernel does not take raise."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as tattn
    q = torch.randn(1, 2, 300, 64, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    before = fmod.DENSE_LAUNCHES["bf16"]
    ops.flash_attention(q, q, q)
    qm = q.transpose(1, 2)[:, :, :, None]            # model layout, G = 1
    tattn.attention(qm, q.transpose(1, 2), q.transpose(1, 2))
    tattn.attention(qm, q.transpose(1, 2), q.transpose(1, 2),
                    impl="reference")                # the oracle: no launch
    assert fmod.DENSE_LAUNCHES["bf16"] == before + 2
    with pytest.raises(ValueError):                  # Sq != Sk, causal
        fmod.flash_attention_cuda(q, q[:, :, :200].contiguous(),
                                  q[:, :, :200].contiguous())
    with pytest.raises(ValueError):                  # Sq != Sk, windowed
        fmod.flash_attention_cuda(q, q[:, :, :200].contiguous(),
                                  q[:, :, :200].contiguous(), causal=False,
                                  window=64)
    with pytest.raises(ValueError):                  # head_dim 80
        x = torch.zeros(1, 2, 32, 80, device="cuda", dtype=torch.bfloat16)
        fmod.flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError):                  # f32 at head_dim 256
        x = torch.zeros(1, 2, 32, 256, device="cuda")
        fmod.flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError):                  # not contiguous
        fmod.flash_attention_cuda(q.transpose(1, 2), q.transpose(1, 2),
                                  q.transpose(1, 2))


# unmasked attention with Sq != Sk (the encoder-decoder's cross attention:
# seamless-m4t-medium's 16 heads of 64 over its 4096 encoder rows, from a
# 64-row chunk or a prompt's bucket), ragged on both sides, and at head_dim
# 128 and 256 (the wide path)
CROSS_SHAPES = [((1, 16, 64, 64), 4096), ((1, 16, 256, 64), 4096),
                ((1, 16, 37, 64), 4096), ((2, 3, 300, 64), 77),
                ((1, 4, 64, 128), 1000), ((1, 2, 100, 256), 300)]


@pytest.mark.parametrize("shape,sk", CROSS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cross_matches_plain(gen, shape, sk, dtype):
    """Dense flash attention of Sq query rows over Sk keys, unmasked,
    against `flash_attention_ref` (f32 takes head_dim up to 128)."""
    from repro_torch.kernels.ref import flash_attention_ref
    if dtype == torch.float32 and shape[3] > 128:
        pytest.skip("the f32 path takes head_dim up to 128")
    b, h, sq, d = shape
    q = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, h, sk, d, generator=gen, device="cuda").to(dtype)
            for _ in "kv")
    got = fmod.flash_attention_cuda(q, k, v, causal=False)
    want = flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= _out_tol(dtype,
                                                                       want)


@pytest.mark.parametrize("d", [64, 256])
def test_flash_attention_cross_row_does_not_depend_on_sq(gen, d):
    """An unmasked row's result depends on its query and the keys only: the
    rows of a 64-row call (a chunk's cross attention) equal the same rows
    of a 256-row call (a prompt's) and of a 37-row call, bit for bit, on
    the tensor-core paths ("mma" at head_dim 64, "wide" at 256)."""
    h = 16 if d == 64 else 4
    q = torch.randn(1, h, 256, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn(1, h, 4096, d, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in "kv")
    full = fmod.flash_attention_cuda(q, k, v, causal=False)
    for r0, n in ((0, 64), (64, 64), (192, 64), (100, 37)):
        part = fmod.flash_attention_cuda(q[:, :, r0:r0 + n].contiguous(), k,
                                         v, causal=False)
        assert torch.equal(_bits(part), _bits(full[:, :, r0:r0 + n])), \
            (r0, n)


@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 70, 512, 1024])
@pytest.mark.parametrize("k,n", [(960, 960), (960, 320), (960, 2560),
                                 (2560, 960), (100, 33)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_int8_matmul_matches_plain(gen, m, k, n, xdt):
    x = torch.randn(m, k, generator=gen, device="cuda").to(xdt)
    wq, s = quantize_weight_ref(torch.randn(k, n, generator=gen, device="cuda"))
    s = s.contiguous()
    key = f"M{m}xK{k}xN{n}"
    before = mmod.LAUNCHES[key]
    got = mmod.int8_matmul(x, wq, s)
    want = int8_matmul_ref(x, wq, s)
    torch.cuda.synchronize()
    assert mmod.LAUNCHES[key] == before + 1
    big = want.float().abs().max().item()
    tol = big * (1e-5 if xdt == torch.float32 else 2 ** -7)
    assert (got.float() - want.float()).abs().max().item() <= tol


def _bits(t):
    """The raw bit pattern of a float tensor, for bit-for-bit comparisons
    (torch.equal would call -0.0 and 0.0 equal)."""
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}
                  [t.dtype])


@pytest.mark.parametrize("k,n", [(960, 960), (960, 320), (960, 2560),
                                 (2560, 960)] + QWEN32_KN)
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_int8_matmul_row_alone_equals_row_in_batch(gen, k, n, xdt):
    """GEMV path: the K split depends on (K, N) only, so a row's output at
    M = 1 equals the same row's inside M = 8 bit for bit."""
    x = torch.randn(8, k, generator=gen, device="cuda").to(xdt)
    wq, s = quantize_weight_ref(torch.randn(k, n, generator=gen, device="cuda"))
    s = s.contiguous()
    batch = mmod.int8_matmul(x, wq, s)
    for r in range(8):
        alone = mmod.int8_matmul(x[r:r + 1].contiguous(), wq, s)
        assert torch.equal(_bits(alone[0]), _bits(batch[r])), f"row {r}"


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("kv,g,d", [(5, 3, 64), QWEN32_HEADS])
def test_decode_attention_alone_batched_paged_dense_bit_identical(
        gen, cdt, window, kv, g, d):
    """Split-KV with a fixed split length: each sequence of the serve batch
    (smollm-360m's and qwen2.5-32b's kv heads, group and head_dim; page 32,
    depth 1024) decoded alone equals it decoded in the batch of 8, and the
    paged pool equals the dense cache holding the same rows, bit for
    bit."""
    b, ps, pps = 8, 32, 32
    n_pages = 1 + b * pps
    pk, pv, ks, vs = _pools(gen, n_pages, ps, kv, d, cdt)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(b, pps).to(torch.int32).contiguous()
    q = torch.randn(b, 1, kv, g, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    kv_len = torch.tensor([674, 517, 424, 246, 274, 78, 103, 1024],
                          dtype=torch.int32, device="cuda")
    idx = table.long()
    dense = [p[idx].reshape(b, -1, kv, d).contiguous() for p in (pk, pv)]
    dscale = [None, None] if ks is None else [
        sc[idx].reshape(b, -1, kv).contiguous() for sc in (ks, vs)]
    paged_all = dmod.decode_attention_cuda(
        q, pk, pv, kv_len, page_table=table, k_scale=ks, v_scale=vs,
        window=window)
    dense_all = dmod.decode_attention_cuda(
        q, *dense, kv_len, k_scale=dscale[0], v_scale=dscale[1],
        window=window)
    assert torch.equal(_bits(paged_all), _bits(dense_all))
    for i in range(b):
        one = slice(i, i + 1)
        alone_p = dmod.decode_attention_cuda(
            q[one], pk, pv, kv_len[one], page_table=table[one].contiguous(),
            k_scale=ks, v_scale=vs, window=window)
        alone_d = dmod.decode_attention_cuda(
            q[one], *(t[one] for t in dense), kv_len[one],
            k_scale=None if ks is None else dscale[0][one],
            v_scale=None if ks is None else dscale[1][one], window=window)
        assert torch.equal(_bits(alone_p), _bits(paged_all[one])), f"seq {i}"
        assert torch.equal(_bits(alone_d), _bits(paged_all[one])), f"seq {i}"


def _leaf(gen, n, dtype, kind):
    """A gradient-like leaf of n values, a different scale in every block;
    `kind` adds the all-zero, tie or NaN case."""
    nb = -(-n // 256)
    scale = torch.exp(torch.randn(nb, generator=gen, device="cuda") * 3)
    x = (torch.randn(nb, 256, generator=gen, device="cuda")
         * scale[:, None]).reshape(-1)[:n]
    if kind == "zero":
        x = torch.zeros_like(x)
    elif kind == "tie" and n >= 256:       # absmax 127 → scale exactly 1.0
        x[:256] = torch.arange(256, device="cuda") % 127 - 63.5
        x[0] = 127.0
    elif kind == "nan":
        x[n // 2] = float("nan")
    return x.to(dtype)


@pytest.mark.parametrize("n", [1, 255, 960, 2049, 5000, 2 ** 24 + 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "zero", "tie", "nan"])
def test_block_quantizers_bit_equal_plain(gen, n, dtype, kind):
    """quantize_blocks / dequantize_blocks (f32 and bf16 out) equal their
    plain versions bit for bit, through the padding of `ops`; a NaN block
    has a NaN scale in both and its (undefined) int8 values are skipped."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qmod
    from repro_torch.kernels.ref import dequantize_blocks_ref, quantize_blocks_ref
    x = _leaf(gen, n, dtype, kind)
    before = dict(qmod.LAUNCHES)
    q, s, nn = ops.quantize_blocks(x)
    x2d = torch.nn.functional.pad(x.reshape(-1), (0, q.numel() - n)).reshape(-1, 256)
    wq, ws, _ = quantize_blocks_ref(x2d)
    torch.cuda.synchronize()
    assert nn == n and q.shape == (s.shape[0], 256) and s.shape[0] % 8 == 0
    assert qmod.LAUNCHES["quantize_blocks"] == before.get("quantize_blocks", 0) + 1
    nan = torch.isnan(ws)
    assert torch.equal(torch.isnan(s), nan) and bool(nan.any()) == (kind == "nan")
    assert torch.equal(s[~nan], ws[~nan])
    assert torch.equal(q[~nan], wq[~nan])
    if kind == "zero":
        assert not q.any()
    if kind == "tie" and n >= 256:
        assert s[0].item() == 1.0
    for out in (torch.float32, torch.bfloat16):
        got = qmod.dequantize_blocks_cuda(q, s, out)
        want = dequantize_blocks_ref(q, s, q.numel(), q.shape, out)
        torch.cuda.synchronize()
        assert got.dtype == out
        assert torch.equal(got[~nan], want[~nan])
        assert torch.isnan(got[nan].float()).all()
    back = ops.dequantize_blocks(q, s, n, x.shape)
    assert back.shape == x.shape and back.dtype == torch.float32


def test_block_quantizers_refuse_what_they_do_not_take(gen):
    from repro_torch.kernels import quantize as qmod
    x = torch.zeros(8, 256, device="cuda")
    with pytest.raises(TypeError):
        qmod.quantize_blocks_cuda(x.half())
    with pytest.raises(ValueError):
        qmod.quantize_blocks_cuda(torch.zeros(8, 128, device="cuda"))
    with pytest.raises(ValueError):                 # misaligned view
        qmod.quantize_blocks_cuda(torch.zeros(8 * 256 + 1, device="cuda")[1:]
                                  .reshape(8, 256))
    with pytest.raises(ValueError):
        qmod.dequantize_blocks_cuda(torch.zeros(8, 256, dtype=torch.int8,
                                                device="cuda"), torch.ones(8))


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn(4, 64, device="cuda")
    wq = torch.zeros(64, 32, dtype=torch.int8, device="cuda")
    s = torch.ones(32, device="cuda")
    with pytest.raises(TypeError):
        mmod.int8_matmul_cuda(x.half(), wq, s)
    with pytest.raises(ValueError):
        mmod.int8_matmul_cuda(x.t().contiguous().t(), wq, s)
    with pytest.raises(ValueError):
        mmod.int8_matmul_cuda(x, wq.cpu(), s)
    q = torch.randn(1, 1, 1, 17, 64, device="cuda")     # 17 > 16 heads per kv
    pool = torch.zeros(2, 8, 1, 64, device="cuda")
    table = torch.ones(1, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        dmod.decode_attention_cuda(q, pool, pool, torch.ones(1, device="cuda"),
                                   page_table=table)
    q = torch.randn(1, 4, 1, 9, 64, device="cuda")      # f32 q: G <= 8
    with pytest.raises(ValueError):
        fmod.flash_attention_paged_cuda(
            q, pool, pool, table, torch.zeros(1, device="cuda"),
            torch.ones(1, device="cuda"))
    q = torch.randn(1, 1, 1, 4, 576, device="cuda")     # latent: one pool
    lat = torch.zeros(2, 8, 1, 576, device="cuda")
    with pytest.raises(ValueError):
        dmod.decode_attention_cuda(q, lat, lat.clone(),
                                   torch.ones(1, device="cuda"),
                                   page_table=table, v_dim=512)


@pytest.mark.parametrize("k,n", [(960, 960), (960, 2560), (2560, 960),
                                 (2048, 2048), (2048, 5632), (5632, 2048)]
                         + QWEN32_KN)
def test_int8_matmul_row_at_chunk_equals_row_in_bucket(gen, k, n):
    """Tensor-core path: the K split depends on (K, N) only, so a row's
    output in a 64-row prefill chunk equals the same row's inside a 512- or
    1024-row prefill bucket, bit for bit (a chunked and a monolithic
    prefill project a prompt row alike)."""
    x = torch.randn(1024, k, generator=gen, device="cuda").to(torch.bfloat16)
    wq, s = quantize_weight_ref(torch.randn(k, n, generator=gen, device="cuda"))
    s = s.contiguous()
    assert mmod.plan(64, k, n, x.dtype) == mmod.plan(1024, k, n, x.dtype)
    full = mmod.int8_matmul(x, wq, s)
    half = mmod.int8_matmul(x[:512].contiguous(), wq, s)
    assert torch.equal(_bits(half), _bits(full[:512]))
    for c0 in (0, 448, 960):
        chunk = mmod.int8_matmul(x[c0:c0 + 64].contiguous(), wq, s)
        assert torch.equal(_bits(chunk), _bits(full[c0:c0 + 64])), c0


@pytest.mark.parametrize("m", [8, 64, 70])
@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048), (100, 33)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_int8_matmul_batched_matches_plain_and_2d(gen, m, k, n, xdt):
    """Every expert's slice equals the 2-D kernel on that slice bit for bit
    (both paths, split and unsplit), and the batched output is within the
    2-D tolerance of `int8_matmul_batched_ref`; one launch counts once."""
    e = 6
    x = torch.randn(e, m, k, generator=gen, device="cuda").to(xdt)
    qs = [quantize_weight_ref(w) for w in
          torch.randn(e, k, n, generator=gen, device="cuda")]
    wq = torch.stack([q for q, _ in qs])
    sc = torch.stack([sc for _, sc in qs]).contiguous()
    key = f"E{e}xM{m}xK{k}xN{n}"
    before = mmod.LAUNCHES[key]
    got = mmod.int8_matmul_batched(x, wq, sc)
    want = mmod.int8_matmul_batched_ref(x, wq, sc)
    torch.cuda.synchronize()
    assert mmod.LAUNCHES[key] == before + 1
    assert got.shape == (e, m, n) and got.dtype == xdt
    big = want.float().abs().max().item()
    tol = big * (1e-5 if xdt == torch.float32 else 2 ** -7)
    assert (got.float() - want.float()).abs().max().item() <= tol
    for i in range(e):
        one = mmod.int8_matmul(x[i].contiguous(), wq[i].contiguous(),
                               sc[i].contiguous())
        assert torch.equal(_bits(one), _bits(got[i])), f"expert {i}"


@pytest.mark.parametrize("m", [8, 64, 70])
@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048), (100, 33)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_int8_matmul_batched_walk_bit_equal_to_2d(gen, m, k, n, xdt):
    """qwen2-moe's 60 experts fill the card, so the batched launch walks
    each tile's K splits in one block (both paths; the ragged (100, 33)
    walks where its tiles fill the card, f32 x above 16 rows): every
    expert's slice still equals the 2-D kernel's split blocks on that
    slice bit for bit, and the output is within the 2-D tolerance of
    `int8_matmul_batched_ref`. Most rows are +0.0 or -0.0, as the
    dispatch's empty capacity slots are, and one expert is all zero: the
    walk's running total starts at +0.0 as the split merge does."""
    e = 60
    p = mmod.batched_plan(e, m, k, n, xdt)
    assert p.walk == ((k, n) != (100, 33) or (xdt == torch.float32 and m > 16))
    x = torch.randn(e, m, k, generator=gen, device="cuda")
    x[:, 1::3] = 0.0
    x[:, 2::3] = -0.0
    x[7] = 0.0
    x = x.to(xdt)
    qs = [quantize_weight_ref(w) for w in
          torch.randn(e, k, n, generator=gen, device="cuda")]
    wq = torch.stack([q for q, _ in qs])
    sc = torch.stack([sc for _, sc in qs]).contiguous()
    key = f"E{e}xM{m}xK{k}xN{n}"
    before = mmod.LAUNCHES[key]
    got = mmod.int8_matmul_batched(x, wq, sc)
    want = mmod.int8_matmul_batched_ref(x, wq, sc)
    torch.cuda.synchronize()
    assert mmod.LAUNCHES[key] == before + 1
    assert got.shape == (e, m, n) and got.dtype == xdt
    big = want.float().abs().max().item()
    tol = big * (1e-5 if xdt == torch.float32 else 2 ** -7)
    assert (got.float() - want.float()).abs().max().item() <= tol
    for i in range(e):
        one = mmod.int8_matmul(x[i].contiguous(), wq[i].contiguous(),
                               sc[i].contiguous())
        assert torch.equal(_bits(one), _bits(got[i])), f"expert {i}"


def test_int8_matmul_batched_refuses_what_it_does_not_take(gen):
    x = torch.zeros(2, 8, 64, dtype=torch.bfloat16, device="cuda")
    wq = torch.zeros(2, 64, 32, dtype=torch.int8, device="cuda")
    sc = torch.ones(2, 32, device="cuda")
    with pytest.raises(ValueError):                   # experts differ
        mmod.int8_matmul_batched(x, wq[:1], sc[:1])
    with pytest.raises(ValueError):                   # scales per expert
        mmod.int8_matmul_batched(x, wq, sc[0])
    with pytest.raises(TypeError):
        mmod.int8_matmul_batched(x, wq.float(), sc)
    with pytest.raises(ValueError):                   # CPU operand
        mmod.int8_matmul_batched(x, wq, sc.cpu())


def _dense_and_chunked(gen, pdt, kv, g, d, s=1024, ps=32):
    """`fmod.dense_and_chunked` on random rows of one S-row prompt through
    a shuffled page table."""
    table = (torch.randperm(s // ps, generator=gen, device="cuda") + 1
             ).reshape(1, -1).to(torch.int32).contiguous()
    k, v = (torch.randn(s, kv, d, generator=gen, device="cuda") for _ in "kv")
    q = torch.randn(1, s, kv, g, d, generator=gen,
                    device="cuda").to(torch.bfloat16)
    return fmod.dense_and_chunked(q, k, v, pdt, table)


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("kv,g,d", [(5, 3, 64), (16, 1, 128), QWEN32_HEADS])
def test_dense_flash_row_equals_chunk_row(gen, pdt, kv, g, d):
    """Both tensor-core paths sum a row's keys in the same 128-key splits
    and merge them alike (csrc/attn_mma.cuh): a row of causal dense
    attention at S = 1024 equals the chunk kernel's row over the same K/V
    in a pool, bit for bit, at smollm-360m's and qwen2-moe-a2.7b's heads."""
    out_d, out_c = _dense_and_chunked(gen, pdt, kv, g, d)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out_d), _bits(out_c))


# B7: the shapes the reference's configs reach beyond G 8 and head_dim 128:
# chatglm3-6b (G 16, D 128), gemma-7b (G 1, D 256), recurrentgemma-2b
# (G 10, D 256), both at once (G 16, D 256); and MLA latent rows (G 16,
# keys 576 wide, values their first 512 columns, one pool as k and v)
WIDE_SHAPES = [(2, 16, 128), (2, 1, 256), (1, 10, 256), (1, 16, 256)]
LATENT_DK, LATENT_DV = dmod.LATENT


def _latent_pool(gen, n_pages, ps, dtype):
    pool = torch.randn(n_pages, ps, 1, LATENT_DK, generator=gen, device="cuda")
    if dtype == torch.int8:
        return quantize_kv_rows(pool)
    return pool.to(dtype), None


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("kv,g,d", WIDE_SHAPES + [(1, 16, "latent")])
def test_decode_attention_wide_matches_plain(gen, paged, qdt, cdt, kv, g, d):
    """The wide decode path (G > 8, head_dim 256, latent rows) against the
    plain version, kv_len on the 256-key split edges, window 0 and 40."""
    b, ps, pps, kv_lens = DECODE_LENS["split_edges"]
    n_pages = 1 + b * pps
    latent = d == "latent"
    if latent:
        d = LATENT_DK
        pk, ks = _latent_pool(gen, n_pages, ps, cdt)
        pv, vs = pk, ks
    else:
        pk, pv, ks, vs = _pools(gen, n_pages, ps, kv, d, cdt)
    vd = LATENT_DV if latent else None
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(b, pps).to(torch.int32).contiguous()
    q = torch.randn(b, 1, kv, g, d, generator=gen, device="cuda").to(qdt)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    if not paged:
        idx = table.long()
        pk = pk[idx].reshape(b, -1, kv, d).contiguous()
        pv = pk if latent else pv[idx].reshape(b, -1, kv, d).contiguous()
        if ks is not None:
            ks = ks[idx].reshape(b, -1, kv).contiguous()
            vs = ks if latent else vs[idx].reshape(b, -1, kv).contiguous()
        table = None
    for window in (0, 40):
        kw = dict(page_table=table, k_scale=ks, v_scale=vs, window=window,
                  v_dim=vd)
        before = sum(dmod.LAUNCHES.values())
        got = dmod.decode_attention_cuda(q, pk, pv, kv_len, **kw)
        want = dmod.decode_attention_plain(q, pk, pv, kv_len, **kw)
        torch.cuda.synchronize()
        assert sum(dmod.LAUNCHES.values()) == before + 1
        assert got.dtype == qdt and got.shape == want.shape
        # a bf16 latent pool: the kernel rounds unnormalized probabilities
        # to bf16 where the plain version rounds normalized ones
        tol = 2 ** -6 if latent and cdt == torch.bfloat16 else _tol(qdt)
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_decode_attention_fp8_cache_matches_plain(gen, paged, qdt):
    """e5m2 caches (dense, as the engine serves them, and paged) upcast
    exactly in the load: within the f32/bf16 tolerance of the plain
    version, which upcasts the gathered rows."""
    b, ps, pps, kv_lens = DECODE_LENS["split_edges"]
    kv, g, d = 5, 3, 64
    n_pages = 1 + b * pps
    pk, pv, _, _ = _pools(gen, n_pages, ps, kv, d, torch.float32)
    pk, pv = pk.to(torch.float8_e5m2), pv.to(torch.float8_e5m2)
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
             ).reshape(b, pps).to(torch.int32).contiguous()
    if not paged:
        idx = table.long()
        pk, pv = (p[idx].reshape(b, -1, kv, d).contiguous() for p in (pk, pv))
        table = None
    q = torch.randn(b, 1, kv, g, d, generator=gen, device="cuda").to(qdt)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    layout = "paged" if paged else "dense"
    before = dmod.LAUNCHES[f"{layout}/fp8"]
    got = dmod.decode_attention_cuda(q, pk, pv, kv_len, page_table=table)
    want = dmod.decode_attention_plain(q, pk, pv, kv_len, page_table=table)
    torch.cuda.synchronize()
    assert dmod.LAUNCHES[f"{layout}/fp8"] == before + 1
    assert (got.float() - want.float()).abs().max().item() <= _tol(qdt)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("kv,g,d", [(2, 16, 128), (1, 16, 256),
                                    (1, 16, "latent")])
def test_decode_attention_wide_alone_equals_batched(gen, cdt, kv, g, d):
    """The wide path's split length is the constant 256 too: a sequence
    decoded alone equals it in the batch of 6, paged and dense."""
    b, ps, pps, kv_lens = DECODE_LENS["split_edges"]
    n_pages = 1 + b * pps
    latent = d == "latent"
    if latent:
        d = LATENT_DK
        pk, ks = _latent_pool(gen, n_pages, ps, cdt)
        pv, vs = pk, ks
    else:
        pk, pv, ks, vs = _pools(gen, n_pages, ps, kv, d, cdt)
    vd = LATENT_DV if latent else None
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
             ).reshape(b, pps).to(torch.int32).contiguous()
    q = torch.randn(b, 1, kv, g, d, generator=gen,
                    device="cuda").to(torch.bfloat16)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, v_dim=vd)
    batched = dmod.decode_attention_cuda(q, pk, pv, kv_len, page_table=table,
                                         **kw)
    idx = table.long()
    dk = pk[idx].reshape(b, -1, kv, d).contiguous()
    dv = dk if latent else pv[idx].reshape(b, -1, kv, d).contiguous()
    dks = dvs = None
    if ks is not None:
        dks = ks[idx].reshape(b, -1, kv).contiguous()
        dvs = dks if latent else vs[idx].reshape(b, -1, kv).contiguous()
    dense = dmod.decode_attention_cuda(q, dk, dv, kv_len, k_scale=dks,
                                       v_scale=dvs, v_dim=vd)
    assert torch.equal(_bits(dense), _bits(batched))
    for i in (0, 3, b - 1):
        alone = dmod.decode_attention_cuda(
            q[i:i + 1].contiguous(), pk, pv, kv_len[i:i + 1],
            page_table=table[i:i + 1].contiguous(), **kw)
        assert torch.equal(_bits(alone), _bits(batched[i:i + 1]))


# The wide paths' edges. Decode, as (kv_len, window): live keys below one
# 8-key pass and below one 32-key tile; across the 256-key split edge,
# starting inside split 0's last tile and ending inside split 1's first;
# keys in one warp's tile of a round only (230-249: warp 3 of round 1);
# across the 512 edge. Chunk attention, as (q_offset, kv_len, rows,
# window): keys below one 64-key tile; a chunk across the 128-key split
# edge inside a tile; keys in one warp's half of a tile only (33-40); a
# full chunk under a narrow window.
WIDE_EDGE_DECODE = [(3, 0), (30, 0), (261, 10), (250, 20), (513, 9)]
WIDE_EDGE_CHUNK = [(0, 5, 5, 0), (120, 136, 16, 0), (40, 41, 1, 8),
                   (100, 164, 64, 10)]


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("kv,g,d", [(2, 1, 256), (1, 16, "latent")])
def test_wide_kernels_at_tile_edges(gen, pdt, kv, g, d):
    """Wide decode and wide chunk attention (bf16 q) against their plain
    versions where a split, tile or warp's share of keys is cut: at
    gemma-7b's G 1 x D 256 and at the latent rows."""
    ps, pps = 32, 20
    n_pages = 1 + len(WIDE_EDGE_DECODE) * pps
    latent = d == "latent"
    if latent:
        d = LATENT_DK
        pk, ks = _latent_pool(gen, n_pages, ps, pdt)
        pv, vs = pk, ks
    else:
        pk, pv, ks, vs = _pools(gen, n_pages, ps, kv, d, pdt)
    vd = LATENT_DV if latent else None
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
             ).reshape(-1, pps).to(torch.int32).contiguous()
    kw = dict(k_scale=ks, v_scale=vs, v_dim=vd)
    tol = 2 ** -6
    for i, (n, window) in enumerate(WIDE_EDGE_DECODE):
        q = torch.randn(1, 1, kv, g, d, generator=gen,
                        device="cuda").to(torch.bfloat16)
        kv_len = torch.tensor([n], dtype=torch.int32, device="cuda")
        t = table[i:i + 1].contiguous()
        got = dmod.decode_attention_cuda(q, pk, pv, kv_len, page_table=t,
                                         window=window, **kw)
        want = dmod.decode_attention_plain(q, pk, pv, kv_len, page_table=t,
                                           window=window, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (n, window, err)
    for off, live, c, window in WIDE_EDGE_CHUNK:
        q = torch.randn(1, c, kv, g, d, generator=gen,
                        device="cuda").to(torch.bfloat16)
        qo = torch.tensor([off], dtype=torch.int32, device="cuda")
        kl = torch.tensor([live], dtype=torch.int32, device="cuda")
        t = table[:1].contiguous()
        got = fmod.flash_attention_paged_cuda(q, pk, pv, t, qo, kl,
                                              window=window, **kw)
        want = fmod.flash_attention_paged_plain(q, pk, pv, t, qo, kl,
                                                window=window, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (off, live, c, window, err)


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("span", [(0, 64), (96, 130), (0, 0), (480, 520)])
@pytest.mark.parametrize("kv,g,d", WIDE_SHAPES + [(1, 16, "latent")])
def test_chunk_attention_wide_matches_plain(gen, pdt, span, kv, g, d):
    """The chunk kernel's tensor-core path at the wide shapes (bf16 q),
    windows 0 and 20, spans across its 128-key split edges."""
    ps, pps, C = 32, 32, 64
    n_pages = 1 + 2 * pps
    latent = d == "latent"
    if latent:
        d = LATENT_DK
        pk, ks = _latent_pool(gen, n_pages, ps, pdt)
        pv, vs = pk, ks
    else:
        pk, pv, ks, vs = _pools(gen, n_pages, ps, kv, d, pdt)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm[:pps].reshape(1, pps).to(torch.int32).contiguous()
    q = torch.randn(1, C, kv, g, d, generator=gen,
                    device="cuda").to(torch.bfloat16)
    off, live = span
    qo = torch.tensor([off], dtype=torch.int32, device="cuda")
    kl = torch.tensor([live], dtype=torch.int32, device="cuda")
    for window in (0, 20):
        kw = dict(k_scale=ks, v_scale=vs, window=window,
                  v_dim=LATENT_DV if latent else None)
        before = sum(fmod.LAUNCHES.values())
        got = fmod.flash_attention_paged_cuda(q, pk, pv, table, qo, kl, **kw)
        want = fmod.flash_attention_paged_plain(q, pk, pv, table, qo, kl, **kw)
        torch.cuda.synchronize()
        assert sum(fmod.LAUNCHES.values()) == before + 1
        assert got.shape == want.shape
        assert (got.float() - want.float()).abs().max().item() <= 2 ** -6
        if live == 0:
            assert torch.all(got == 0)


@pytest.mark.parametrize("shape", [(1, 16, 1024, 256), (1, 16, 658, 256),
                                   (2, 1, 300, 160), (1, 2, 512, 192),
                                   (1, 2, 384, 224), (1, 4, 256, 96),
                                   (1, 2, 1300, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_wide_matches_plain(gen, shape, causal):
    """Dense flash attention at head_dim 96 and 160-256 (bf16): gemma-7b's
    16 heads of 256 at S 1024, the ragged 658 and 1300 (eleven splits a
    row tile), windows none and 256."""
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    for window in (0, 256):
        got = fmod.flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert got.shape == q.shape
        assert (got.float() - want.float()).abs().max().item() <= 2 ** -6


@pytest.mark.parametrize("s", [1024, 1300])
def test_flash_attention_wide_prefix_equals_shorter_run(gen, s):
    """The first 658 rows of causal dense attention at S = 1024 and 1300
    equal a run at S = 658, bit for bit, at head_dim 256 (the wide path's
    walking blocks)."""
    q, k, v = (torch.randn(1, 4, s, 256, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    full = fmod.flash_attention_cuda(q, k, v)
    short = fmod.flash_attention_cuda(
        *(t[:, :, :658].contiguous() for t in (q, k, v)))
    assert torch.equal(_bits(short), _bits(full[:, :, :658]))


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("kv,g,d", [(2, 16, 128), (2, 1, 256), (1, 10, 256)])
def test_dense_flash_row_equals_chunk_row_wide(gen, pdt, kv, g, d):
    """C1's guard at the wide shapes: a row of causal dense attention at S
    = 1024 equals the chunk kernel's row over the same K/V, bit for bit."""
    out_d, out_c = _dense_and_chunked(gen, pdt, kv, g, d)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out_d), _bits(out_c))


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16, torch.int8])
def test_latent_monolithic_row_equals_chunk_row(gen, pdt):
    """C4's guard: an MLA monolithic prefill (the chunk kernel over the
    prompt's latent rows as one page, `latent_attention`) equals chunked
    prefill in 64-row chunks through a shuffled page table, bit for bit,
    at deepseek-v2-lite's 16 heads on one 576-wide latent row."""
    s, ps = 1024, 32
    table = (torch.randperm(s // ps, generator=gen, device="cuda") + 1
             ).reshape(1, -1).to(torch.int32).contiguous()
    lat = torch.randn(s, 1, LATENT_DK, generator=gen, device="cuda")
    q = torch.randn(1, s, 1, 16, LATENT_DK, generator=gen,
                    device="cuda").to(torch.bfloat16)
    out_d, out_c = fmod.dense_and_chunked(q, lat, None, pdt, table,
                                          v_dim=LATENT_DV)
    torch.cuda.synchronize()
    assert out_d.shape == (1, s, 1, 16, LATENT_DV)
    assert torch.equal(_bits(out_d), _bits(out_c))


@pytest.mark.parametrize("kind", ["mla-bf16", "mla-int8", "fp8"])
def test_mla_and_fp8_caches_launch_the_kernels(gen, kind):
    """MLA latent rows (`v_dim`) and fp8 decode caches launch the kernels on
    the card (the JAX package reads them through its jnp path) and agree
    with the plain versions run on the CPU; an fp8 pool in chunk attention
    (a paged fp8 engine is refused) stays on the plain path."""
    from repro_torch.models import attention as tattn
    b, ps, pps, g = 2, 32, 4, 4
    d, vd = (576, 512) if kind.startswith("mla") else (64, None)
    n_pages = 1 + b * pps
    pool = torch.randn(n_pages, ps, 1, d, generator=gen, device="cuda")
    scales = None
    if kind == "mla-int8":
        pool, scales = quantize_kv_rows(pool)
    elif kind == "fp8":
        pool = pool.to(torch.float8_e5m2)
    else:
        pool = pool.to(torch.bfloat16)
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
             ).reshape(b, pps).to(torch.int32)
    q = torch.randn(b, 1, 1, g, d, generator=gen,
                    device="cuda").to(torch.bfloat16)
    qc = torch.randn(1, 16, 1, g, d, generator=gen,
                     device="cuda").to(torch.bfloat16)
    lens = torch.tensor([40, 97], dtype=torch.int32, device="cuda")

    def calls(dev):
        t = {k: None if v is None else v.to(dev) for k, v in dict(
            q=q, qc=qc, pool=pool, scales=scales, table=table,
            lens=lens).items()}
        dec = tattn.decode_attention(
            t["q"], t["pool"], t["pool"], t["lens"], page_table=t["table"],
            k_scale=t["scales"], v_scale=t["scales"], v_dim=vd)
        chunk = tattn.chunk_attention_paged(
            t["qc"], t["pool"], t["pool"], t["table"][:1],
            t["lens"][:1] - 16, kv_len=t["lens"][:1], k_scale=t["scales"],
            v_scale=t["scales"], v_dim=vd)
        return dec, chunk

    dmod.LAUNCHES.clear()
    fmod.LAUNCHES.clear()
    on_card = calls("cuda")
    torch.cuda.synchronize()
    name = {"mla-bf16": "bf16", "mla-int8": "int8", "fp8": "fp8"}[kind]
    assert dict(dmod.LAUNCHES) == {f"paged/{name}": 1}
    assert dict(fmod.LAUNCHES) == ({} if kind == "fp8" else {name: 1})
    for got, want in zip(on_card, calls("cpu")):
        assert got.is_cuda and got.shape == want.shape
        assert got.shape[-1] == (vd or d)
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   atol=2 ** -6, rtol=0)


@pytest.mark.parametrize("k,n", [(4096, 256), (4096, 4096), (13696, 4096),
                                 (3072, 24576), (960, 320)])
def test_float_projection_rows_do_not_depend_on_m(gen, k, n):
    """bf16 projections (`qeinsum` with a float weight) and the LM head run
    in fixed row blocks on the card: a decode row alone equals it beside 7
    others (`decode_products`), and a prompt row equals it in a 64-row
    chunk, a 1024-row bucket and 658- and 12-row exact-length prefills, bit
    for bit (chatglm3-6b's and gemma-7b's shapes, where the library's
    kernel choice by row count changes the sums); int8 weights too, whose
    prefill of at most 16 rows takes the chunk's tensor-core path."""
    from repro_torch.models.quantized import decode_products, qeinsum
    x = torch.randn(1, 1024, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
    wq, ws = quantize_weight_ref(w)
    for wt in (w.to(torch.bfloat16), {"int8_q": wq, "s": ws[None]}):
        with torch.no_grad():
            full = qeinsum("bsd,df->bsf", x, wt)
            exact = qeinsum("bsd,df->bsf", x[:, :658].contiguous(), wt)
            short = qeinsum("bsd,df->bsf", x[:, :12].contiguous(), wt)
            chunk = qeinsum("bsd,df->bsf", x[:, 64:128].contiguous(), wt)
            with decode_products():
                batch = qeinsum("bsd,df->bsf", x[:, :8].contiguous(), wt)
                alone = qeinsum("bsd,df->bsf", x[:, 3:4].contiguous(), wt)
        assert torch.equal(_bits(exact), _bits(full[:, :658]))
        assert torch.equal(_bits(short), _bits(full[:, :12]))
        assert torch.equal(_bits(chunk), _bits(full[:, 64:128]))
        assert torch.equal(_bits(alone), _bits(batch[:, 3:4]))


@pytest.mark.parametrize("m", [1, 8, 64, 512, 1024])
@pytest.mark.parametrize("k,n", QWEN32_KN)
def test_int8_matmul_matches_plain_at_qwen2_5_32b(gen, m, k, n):
    """int8_matmul at qwen2.5-32b's four (K, N) (w1/w3 and w2 are 141.6 MB
    of int8 each) on the serve path's M, bf16 x: within one bf16 ulp of the
    largest output of the plain version."""
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    wq, s = quantize_weight_ref(torch.randn(k, n, generator=gen, device="cuda"))
    s = s.contiguous()
    got = mmod.int8_matmul(x, wq, s)
    want = int8_matmul_ref(x, wq, s)
    torch.cuda.synchronize()
    tol = want.float().abs().max().item() * 2 ** -7
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1024, 658])
def test_flash_attention_matches_plain_at_qwen2_5_32b(gen, s, causal):
    """Dense flash attention at qwen2.5-32b's monolithic prefill: 40 heads
    of 128, bf16; and the first 658 rows of causal S = 1024 equal a run at
    S = 658 bit for bit."""
    q, k, v = (torch.randn(1, 40, s, 128, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in "qkv")
    from repro_torch.kernels.ref import flash_attention_ref
    got = fmod.flash_attention_cuda(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -6
    if causal and s == 1024:
        short = fmod.flash_attention_cuda(q[:, :, :658].contiguous(),
                                          k[:, :, :658].contiguous(),
                                          v[:, :, :658].contiguous(),
                                          causal=True)
        assert torch.equal(_bits(short), _bits(got[:, :, :658]))


@pytest.mark.parametrize("s", [704, 2040, 2600])
def test_flash_attention_matches_plain_at_recurrentgemma(gen, s):
    """Dense flash attention at recurrentgemma-2b's monolithic prefill: 10
    heads of 256 (its one KV head expanded), bf16, causal, window 2048 (S
    2600 drops keys), against the plain version; one bf16 launch each."""
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = (torch.randn(1, 10, s, 256, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in "qkv")
    before = fmod.DENSE_LAUNCHES["bf16"]
    got = fmod.flash_attention_cuda(q, k, v, causal=True, window=2048)
    want = flash_attention_ref(q, k, v, causal=True, window=2048)
    torch.cuda.synchronize()
    assert fmod.DENSE_LAUNCHES["bf16"] == before + 1
    assert (got.float() - want.float()).abs().max().item() <= _tol(
        torch.bfloat16)


def test_decode_attention_ring_alone_equals_batch(gen):
    """Decode over recurrentgemma-2b's dense 2048-row f32 rings (KV 1, G 10,
    D 256, bf16 q) at kv_len 1, 700, 2047 and 2048: within tolerance of the
    plain version, each sequence decoded alone bit-equal to it in the
    batch of 8."""
    b, w = 8, 2048
    kv_len = torch.tensor([1, 700, 2047, 2048] * 2, dtype=torch.int32,
                          device="cuda")
    kc, vc = (torch.randn(b, w, 1, 256, generator=gen, device="cuda")
              for _ in "kv")
    q = torch.randn(b, 1, 1, 10, 256, generator=gen, device="cuda").to(
        torch.bfloat16)
    got = dmod.decode_attention_cuda(q, kc, vc, kv_len)
    want = dmod.decode_attention_plain(q, kc, vc, kv_len)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _tol(
        torch.bfloat16)
    for i in range(b):
        one = dmod.decode_attention_cuda(q[i:i + 1], kc[i:i + 1], vc[i:i + 1],
                                         kv_len[i:i + 1])
        assert torch.equal(_bits(one[0]), _bits(got[i]))


# ---------------------------------------------------------------------------
# captured serving steps (serve/graphs.py): CUDA graphs replayed on the card
# ---------------------------------------------------------------------------

def _launches():
    from repro_torch.serve.graphs import launch_counters
    return [dict(c) for c in launch_counters()]


def _reset_launches():
    from repro_torch.serve.graphs import launch_counters
    for c in launch_counters():
        c.clear()


def test_step_graph_replays_and_counts_launches(gen):
    """A captured int8_matmul step: the first call runs for real, the
    capture adds no launch, each replay adds one, and every call equals the
    kernel called directly on its inputs, bit for bit. A rebound state
    tensor makes the next call raise."""
    from repro_torch.serve.engine import EngineStats
    from repro_torch.serve.graphs import StepGraph

    class Owner:                    # a step holds its engine weakly
        stats = EngineStats()
        w = torch.randint(-127, 128, (96, 160), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand(160, generator=gen, device="cuda") / 64
    owner = Owner()
    step = StepGraph(owner, lambda o, inp: mmod.int8_matmul_cuda(
        inp["x"], o.w, o.s), {"x": ((8, 96), torch.float32)},
        state=lambda o: [o.w, o.s], stat="decode_compiles", label="decode",
        device="cuda", eager=False)
    mmod.LAUNCHES.clear()
    key = "M8xK96xN160"
    for i in range(4):
        x = torch.randn(8, 96, generator=gen, device="cuda")
        got = step(x=x.cpu().numpy()).clone()
        assert mmod.LAUNCHES[key] == i + 1
        want = mmod.int8_matmul_cuda(x, owner.w, owner.s)
        mmod.LAUNCHES[key] -= 1
        assert torch.equal(got, want), i
    assert step.captured and step.captures == 1
    assert owner.stats.decode_compiles == 1
    owner.w = owner.w.clone()
    with pytest.raises(RuntimeError, match="rebound"):
        step(x=x.cpu().numpy())


def _smoke_engine(arch, eager, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeEngine
    model = build_model(get_config(arch).smoke(), device="cuda")
    params = model.init(seed=0)
    return ServeEngine(model, params=params, n_slots=4, max_len=128,
                       page_size=16, keep_logits=True, eager=eager,
                       device="cuda", **kw)


def _smoke_traffic(eng, sample=True):
    import numpy as np
    rng = np.random.default_rng(5)
    reqs = []
    for i, n in enumerate((40, 7, 70, 23, 33)):
        extras = None
        if eng.cfg.family == "vlm" and i % 2 == 0:
            extras = {"patch_embeds": rng.standard_normal(
                (min(n, 12), eng.cfg.d_model)).astype(np.float32)}
        if eng.cfg.family == "encdec":
            extras = {"frames": rng.standard_normal(
                (eng.cfg.cross_len, eng.cfg.d_model)).astype(np.float32)}
        reqs.append(eng.submit(
            rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=6, extras=extras, seed=i,
            sample_params=(0.8, 20, 0.9) if sample and i == 3 else None))
    return reqs


# every family the engine serves at its `.smoke()` size; MLA's smoke latent
# rows (48 wide) are no shape the kernels take (latent rows are 576 / 512),
# so deepseek-v2-lite's captured engine is held to its eager twin at full
# width by `chip_smoke.py` phase 3j instead
ENGINE_CASES = [
    ("smollm-360m", dict(wdtype="bf16")),
    ("smollm-360m", dict(wdtype="int8", kv_dtype="int8")),
    ("smollm-360m", dict(wdtype="bf16", paged=False, chunked_prefill=False)),
    ("smollm-360m", dict(wdtype="bf16", chunked_prefill=False)),
    ("qwen2-moe-a2.7b", dict(wdtype="bf16")),
    ("llava-next-mistral-7b", dict(wdtype="bf16")),
    ("seamless-m4t-medium", dict(wdtype="bf16")),
    ("mamba2-780m", dict(wdtype="bf16")),
    ("recurrentgemma-2b", dict(wdtype="bf16")),
]


@pytest.mark.parametrize("arch,kw", ENGINE_CASES,
                         ids=[f"{a}-{i}" for i, (a, _) in
                              enumerate(ENGINE_CASES)])
def test_captured_engine_equals_eager_twin(gen, arch, kw):
    """Every family and layout: the engine that captures its steps and its
    `eager=True` twin emit the same tokens and bit-equal kept logits, with
    the same kernel launch counts (replays counted); the captured engine's
    steps are CUDA graphs within COMPILE_BUDGETS, and a second identical
    wave builds nothing and makes one host sync a decode step."""
    from repro_torch.analysis import sanitizer
    from repro_torch.serve.engine import ServeEngine
    runs = {}
    for eager in (False, True):
        eng = _smoke_engine(arch, eager, **kw)
        _reset_launches()
        with sanitizer.compile_budget(**ServeEngine.COMPILE_BUDGETS):
            reqs = _smoke_traffic(eng)
            eng.run_to_completion()
        runs[eager] = (eng, reqs, _launches())
    (cap, creqs, claunch), (eag, ereqs, elaunch) = runs[False], runs[True]
    # the recurrent families' exact-length prefill runs per op (one
    # signature a prompt length); every other built step is a graph
    built = [s for s in cap.steps.values()
             if s.captures and not getattr(s, "per_op", False)]
    assert cap.steps["decode"] in built and all(s.captured for s in built)
    assert not any(s.captured for s in eag.steps.values())
    assert (cap.stats.decode_compiles, cap.stats.chunk_compiles) == \
        (eag.stats.decode_compiles, eag.stats.chunk_compiles)
    for a, b in zip(creqs, ereqs):
        assert a.out_tokens == b.out_tokens, a.rid
        assert all(torch.equal(x, y) for x, y in zip(a.logits, b.logits))
    assert claunch == elaunch
    cap.keep_logits = False
    steps = cap.stats.decode_steps
    with sanitizer.compile_budget(total=0) as log:
        _smoke_traffic(cap, sample=False)
        cap.run_to_completion()
    assert log.host_syncs == cap.stats.decode_steps - steps
