"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card: every decode-attention variant, chunk-prefill attention
(float and int8 pools, windows, no live rows), int8_matmul over ragged
shapes and the gradient block quantizers (bit for bit), plus the launch
counters and the wrappers' refusals.

Marked `cuda`: a CUDA kernel has no CPU mode, so these skip without a GPU.
Run them on a machine with an H100:
    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances: f32 outputs `atol=1e-4` (summation order, expf); bf16 outputs
`atol=2**-6` (one bf16 ulp at |o| < 4). The peaky-score tests give q and k
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


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2 ** -6


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


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("kv,g,d", [(5, 3, 64), (2, 8, 128), (1, 1, 32)])
def test_decode_attention_matches_plain(gen, paged, qdt, cdt, window, kv, g, d):
    b, ps, pps = 4, 16, 6
    n_pages = 1 + b * pps
    pk, pv, ks, vs = _pools(gen, n_pages, ps, kv, d, cdt)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(b, pps).to(torch.int32).contiguous()
    q = torch.randn(b, 1, kv, g, d, generator=gen, device="cuda").to(qdt)
    kv_len = torch.tensor([0, 1, 47, ps * pps + 3], dtype=torch.int32,
                          device="cuda")            # empty, 1, ragged, past cap
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
    assert torch.all(got[0] == 0)
    assert (got.float() - want.float()).abs().max().item() <= _tol(qdt)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("span", [(0, 64), (96, 130), (0, 0), (30, 31)])
def test_chunk_attention_matches_plain(gen, qdt, pdt, window, span):
    kv, g, d, ps, pps, C = 5, 3, 64, 32, 8, 64
    n_pages = 1 + 2 * pps
    pk, pv, ks, vs = _pools(gen, n_pages, ps, kv, d, pdt)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm[:pps].reshape(1, pps).to(torch.int32).contiguous()
    q = torch.randn(1, C, kv, g, d, generator=gen, device="cuda").to(qdt)
    off, live = span
    qo = torch.tensor([off], dtype=torch.int32, device="cuda")
    kl = torch.tensor([live], dtype=torch.int32, device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, window=window)
    got = fmod.flash_attention_paged_cuda(q, pk, pv, table, qo, kl, **kw)
    want = fmod.flash_attention_paged_plain(q, pk, pv, table, qo, kl, **kw)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _tol(qdt)
    if live == 0:
        assert torch.all(got == 0)


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


@pytest.mark.parametrize("m", [1, 8, 64, 70])
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
    q = torch.randn(1, 1, 1, 9, 64, device="cuda")       # 9 > 8 heads per kv
    pool = torch.zeros(2, 8, 1, 64, device="cuda")
    table = torch.ones(1, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        dmod.decode_attention_cuda(q, pool, pool, torch.ones(1, device="cuda"),
                                   page_table=table)
