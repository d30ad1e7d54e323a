#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # everything, on one CUDA card

1. Prints the card's name and power limit, builds every CUDA kernel from the
   sources in `src/repro_torch/csrc` (one nvcc per source, in parallel).
2. Holds every kernel variant against its plain PyTorch version at the main
   path's shapes (smollm-360m: KV=5, G=3, D=64, page 32, chunk 64) and
   prints, per kernel, its error against the stated tolerance and its time
   beside the plain version's, the bound and one PyTorch library call's.
   The attention kernels are also held at the f32 tolerance with q and k at
   the std the schema's own init gives them (a near-one-hot softmax).
   The gradient block quantizers are held bit for bit at all 11 full-width
   gradient leaf shapes of smollm-360m (f32, bf16, zero, tie and NaN
   blocks) and timed per leaf and per compressed step.
3. Serves smollm-360m at full width (random weights from a seeded
   torch.Generator) through `ServeEngine`: (a) bf16 weights with an f32 KV
   pool, (b) int8 weights with an int8 KV pool. Checks that every request
   finishes, the page pool balances and the kernel launch counters match the
   engine's step counts. The timed engine keeps no logits; a second engine
   serves three of the requests again keeping them, and its logits must
   agree with a cacheless teacher-forced pass of the same model.
4. Trains smollm-360m at full width (bf16 params, global batch 8 x seq 512,
   6 steps) through the port's `train_loop`: uncompressed, then with
   compressed gradients (11 quantize and 11 dequantize launches per step),
   then resumes the compressed run from its own checkpoint (bit-equal
   restore, 2 more steps, verified). On step 0's real gradient tree the
   compression through the kernels equals the plain versions bit for bit.
5. Prints one JSON line of kernel results, then the device line last.

Exits non-zero without a CUDA device, outside a checkout of the repository,
or when any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# peak rates of one H100 SXM (NVIDIA data sheet, dense): device memory and
# the operation rates used for a kernel's least time
HBM_BYTES_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}

SMOLLM = dict(kv=5, g=3, d=64, page=32, chunk=64, max_len=1024, slots=8)
N_LAYERS = 32
SERVE_REQUESTS = 12
SERVE_NEW_TOKENS = 32
TF_TOL = 0.1   # teacher-forced logit tolerance, see check_teacher_forced
# std of q and k at layer 0 of smollm-360m under the schema's own init
# (tools/torch_init_scale.py): scores near 100 and a near-one-hot softmax
SCHEMA_QK_STD = (8.0, 13.7)


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20) -> float:
    """Mean device ms of one call. Before each call a 64 MB write evicts the
    50 MB L2 (the serving path finds every layer's pool cold), then a spin
    kernel holds the stream while the host enqueues the call, so the events
    bracket device time only, not Python's launch overhead."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(5_000_000)         # ~3 ms at the H100's clock
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def bound(nbytes: float, ops: float, op_type: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _isz(t) -> int:
    return t.element_size()


def _op_type(*tensors) -> str:
    """f32 operands keep the kernel off the bf16 tensor-core rate; bf16 and
    int8 (exact in bf16) operands may use it."""
    import torch
    return "f32" if any(t.dtype == torch.float32 for t in tensors) else "bf16"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pools(gen, n_pages, ps, kv, d, dtype, peaky=False):
    """Random (n_pages, ps, KV, D) K/V pools in `dtype`; int8 gets f16
    per-row scales as the engine's quantizer writes them.

    `peaky`: K at the schema init's std on integer values (an int8 pool
    holds 2K with scale 0.5), so that with an integer q every score is
    exact in f32 whatever the summation order. The check then holds the
    kernel's softmax and PV in the near-one-hot regime at the f32 tolerance;
    with non-integer values the f32 rounding of scores near 100 alone moves
    both versions' outputs by ~1e-4."""
    import torch
    from repro_torch.models.quantized import quantize_kv_rows
    k = torch.randn(n_pages, ps, kv, d, generator=gen, device="cuda")
    v = torch.randn(n_pages, ps, kv, d, generator=gen, device="cuda")
    if peaky:
        k_std = SCHEMA_QK_STD[1]
        if dtype == torch.int8:
            kq = (k * 2 * k_std).round().clamp(-127, 127).to(torch.int8)
            (vq, vs) = quantize_kv_rows(v)
            half = torch.full(k.shape[:-1], 0.5, dtype=torch.float16,
                              device="cuda")
            return kq, vq, half, vs
        k = (k * k_std).round().clamp(-127, 127)   # exact in bf16 too
    if dtype == torch.int8:
        (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
        return kq, vq, ks, vs
    return k.to(dtype), v.to(dtype), None, None


def _query(gen, shape, dtype, peaky=False):
    """Random q; `peaky`: integer-valued at the schema init's std."""
    import torch
    q = torch.randn(*shape, generator=gen, device="cuda")
    if peaky:
        q = (q * SCHEMA_QK_STD[0]).round()
    return q.to(dtype)


def _peaky_name(peaky) -> str:
    return (f" q/k std {SCHEMA_QK_STD[0]:g}/{SCHEMA_QK_STD[1]:g} integer"
            if peaky else "")


def _tol(dtype) -> float:
    """f32 outputs: summation order and expf, 1e-4. bf16 outputs: the f32
    results may round to neighbouring bf16 values, one ulp at |o| < 4."""
    import torch
    return 1e-4 if dtype == torch.float32 else 2 ** -8 * 4


def check_decode(gen, results, lens):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_plain)
    c = SMOLLM
    b, kv, g, d, ps = c["slots"], c["kv"], c["g"], c["d"], c["page"]
    pps = c["max_len"] // ps
    n_pages = 1 + b * pps
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(b, pps).to(torch.int32).contiguous()
    cases = [  # (layout, q dtype, cache dtype, window, main-path key, timed)
        ("paged", torch.bfloat16, torch.float32, 0, "paged/f32", True),
        ("paged", torch.bfloat16, torch.int8, 0, "paged/int8", True),
        ("paged", torch.bfloat16, torch.bfloat16, 0, None, False),
        ("paged", torch.float32, torch.float32, 0, None, False),
        ("paged", torch.float32, torch.int8, 0, None, False),
        ("paged", torch.bfloat16, torch.float32, 100, None, False),
        # the dense layout (the TPU's other pallas_call) is off the serve
        # path: timed here, but it has no launches to report
        ("dense", torch.bfloat16, torch.float32, 0, None, True),
        ("dense", torch.bfloat16, torch.bfloat16, 0, None, False),
        ("dense", torch.float32, torch.int8, 0, None, False),
        ("dense", torch.float32, torch.float32, 300, None, False),
    ]
    # peaky scores (the schema init's q/k std), f32 q at the f32 tolerance
    peaky = [(layout, torch.float32, cdt, 0, None, False)
             for layout, cdt in (("paged", torch.float32),
                                 ("paged", torch.bfloat16),
                                 ("paged", torch.int8),
                                 ("dense", torch.float32),
                                 ("dense", torch.int8))]
    cases = [(*cs, False) for cs in cases] + [(*cs, True) for cs in peaky]
    for layout, qdt, cdt, window, key, timed, peak in cases:
        q = _query(gen, (b, 1, kv, g, d), qdt, peak)
        pk, pv, ks, vs = _pools(gen, n_pages, ps, kv, d, cdt, peak)
        if layout == "paged":
            k_c, v_c, ks_c, vs_c, pt = pk, pv, ks, vs, table
        else:  # the same rows as a dense (B, Smax, KV, D) cache
            idx = table.long()
            k_c = pk[idx].reshape(b, -1, kv, d).contiguous()
            v_c = pv[idx].reshape(b, -1, kv, d).contiguous()
            ks_c = None if ks is None else ks[idx].reshape(b, -1, kv).contiguous()
            vs_c = None if vs is None else vs[idx].reshape(b, -1, kv).contiguous()
            pt = None
        for lens_case in (kv_len, torch.zeros_like(kv_len)):
            kw = dict(page_table=pt, k_scale=ks_c, v_scale=vs_c, window=window)
            got = decode_attention_cuda(q, k_c, v_c, lens_case, **kw)
            want = decode_attention_plain(q, k_c, v_c, lens_case, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = _tol(qdt)
            name = (f"decode_attention {layout} q={str(qdt)[6:]} "
                    f"cache={str(cdt)[6:]} window={window} "
                    f"kv_len={'0' if not lens_case.any() else 'ragged'}"
                    f"{_peaky_name(peak)}")
            if not err <= tol or not torch.isfinite(got.float()).all():
                fail(f"{name}: max_abs_err {err:.3g} > tol {tol:.3g}")
            if not bool(lens_case.any()) and got.float().abs().max().item() != 0:
                fail(f"{name}: kv_len == 0 must give zeros")
            if not timed or not lens_case.any():
                print(f"[kernel] {name}: max_abs_err {err:.3g} <= {tol:.3g}")
                continue
            ms = time_ms(lambda: decode_attention_cuda(q, k_c, v_c, kv_len, **kw))
            plain_ms = time_ms(lambda: decode_attention_plain(q, k_c, v_c, kv_len, **kw))
            # library yardstick: SDPA on the gathered, dequantized dense view
            kd = pk[table.long()].reshape(b, -1, kv, d).float()
            vd = pv[table.long()].reshape(b, -1, kv, d).float()
            if ks is not None:
                kd = kd * ks[table.long()].reshape(b, -1, kv, 1).float()
                vd = vd * vs[table.long()].reshape(b, -1, kv, 1).float()
            kd = kd.to(qdt).permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
            vd = vd.to(qdt).permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
            qd = q.reshape(b, 1, kv * g, d).permute(0, 2, 1, 3).contiguous()
            mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
                    < kv_len[:, None])[:, None, None, :]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask))
            live = kv_len.clamp(max=pps * ps).long()
            rows = int(live.sum())
            row_bytes = kv * d * _isz(pk) + (kv * 2 if ks is not None else 0)
            table_bytes = 4 * int((-(-live // ps)).sum()) if pt is not None else 0
            nbytes = 2 * q.numel() * _isz(q) + 4 * b + table_bytes \
                + 2 * rows * row_bytes
            ops = 4 * rows * kv * g * d
            bms, by = bound(nbytes, ops, _op_type(q, pk))
            print(f"[kernel] {name}: max_abs_err {err:.3g} <= {tol:.3g}  "
                  f"ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {bms:.5f} "
                  f"({by})  library_ms(sdpa) {lib_ms:.4f}")
            if key is None:
                continue
            results[("decode_attention", key)] = dict(
                name=f"decode_attention[{key}]", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:278",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def check_chunk(gen, results):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_paged_cuda, flash_attention_paged_plain)
    c = SMOLLM
    kv, g, d, ps, C = c["kv"], c["g"], c["d"], c["page"], c["chunk"]
    pps = c["max_len"] // ps
    n_pages = 1 + c["slots"] * pps
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm[:pps].reshape(1, pps).to(torch.int32).contiguous()
    # (q_offset, kv_len): a middle chunk, the ragged last chunk of a
    # 741-token prompt, the first chunk, and no live rows at all
    spans = [(384, 448), (704, 741), (0, 64), (0, 0)]
    cases = [  # (q dtype, pool dtype, window, main-path key)
        (torch.bfloat16, torch.float32, 0, "f32"),
        (torch.bfloat16, torch.int8, 0, "int8"),
        (torch.bfloat16, torch.bfloat16, 0, None),
        (torch.float32, torch.float32, 0, None),
        (torch.float32, torch.int8, 0, None),
        (torch.bfloat16, torch.float32, 100, None),
    ]
    # peaky scores (the schema init's q/k std), f32 q at the f32 tolerance
    peaky = [(torch.float32, pdt, 0, None)
             for pdt in (torch.float32, torch.bfloat16, torch.int8)]
    cases = [(*cs, False) for cs in cases] + [(*cs, True) for cs in peaky]
    for qdt, pdt, window, key, peak in cases:
        pk, pv, ks, vs = _pools(gen, n_pages, ps, kv, d, pdt, peak)
        q = _query(gen, (1, C, kv, g, d), qdt, peak)
        for off, live in spans:
            qo = torch.tensor([off], dtype=torch.int32, device="cuda")
            kl = torch.tensor([live], dtype=torch.int32, device="cuda")
            kw = dict(k_scale=ks, v_scale=vs, window=window)
            got = flash_attention_paged_cuda(q, pk, pv, table, qo, kl, **kw)
            want = flash_attention_paged_plain(q, pk, pv, table, qo, kl, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = _tol(qdt)
            name = (f"flash_attention_paged q={str(qdt)[6:]} "
                    f"pool={str(pdt)[6:]} window={window} "
                    f"q_offset={off} kv_len={live}{_peaky_name(peak)}")
            if not err <= tol or not torch.isfinite(got.float()).all():
                fail(f"{name}: max_abs_err {err:.3g} > tol {tol:.3g}")
            if live == 0 and got.float().abs().max().item() != 0:
                fail(f"{name}: rows with no valid key must give zeros")
            if key is None or off != 384:
                print(f"[kernel] {name}: max_abs_err {err:.3g} <= {tol:.3g}")
                continue
            ms = time_ms(lambda: flash_attention_paged_cuda(q, pk, pv, table, qo, kl, **kw))
            plain_ms = time_ms(lambda: flash_attention_paged_plain(
                q, pk, pv, table, qo, kl, **kw))
            kd = pk[table.long()].reshape(1, -1, kv, d)[:, :live].float()
            vd = pv[table.long()].reshape(1, -1, kv, d)[:, :live].float()
            if ks is not None:
                kd = kd * ks[table.long()].reshape(1, -1, kv, 1)[:, :live].float()
                vd = vd * vs[table.long()].reshape(1, -1, kv, 1)[:, :live].float()
            kd = kd.to(qdt).permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
            vd = vd.to(qdt).permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
            qd = q.reshape(1, C, kv * g, d).permute(0, 2, 1, 3).contiguous()
            qpos = off + torch.arange(C, device="cuda")
            mask = (torch.arange(live, device="cuda")[None, :] <= qpos[:, None])
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask[None, None]))
            pairs = int(mask.sum())
            row_bytes = kv * d * _isz(pk) + (kv * 2 if ks is not None else 0)
            nbytes = (2 * q.numel() * _isz(q) + 8 + 4 * (-(-live // ps))
                      + 2 * live * row_bytes)
            ops = 4 * pairs * kv * g * d
            bms, by = bound(nbytes, ops, _op_type(q, pk))
            print(f"[kernel] {name}: max_abs_err {err:.3g} <= {tol:.3g}  "
                  f"ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {bms:.5f} "
                  f"({by})  library_ms(sdpa) {lib_ms:.4f}")
            results[("flash_attention_paged", key)] = dict(
                name=f"flash_attention_paged[{key}]", route="cuda",
                source="src/repro_torch/csrc/flash_attention_paged.cu",
                replaces="src/repro/kernels/flash_attention.py:271",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def check_int8_matmul(gen, results):
    import torch
    from repro_torch.kernels.int8_matmul import int8_matmul_cuda
    from repro_torch.kernels.ref import int8_matmul_ref, quantize_weight_ref
    shapes = [(960, 960), (960, 320), (960, 2560), (2560, 960)]
    for m in (SMOLLM["slots"], SMOLLM["chunk"]):
        for k, n in shapes:
            for xdt in (torch.bfloat16, torch.float32):
                x = torch.randn(m, k, generator=gen, device="cuda").to(xdt)
                w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
                wq, s = quantize_weight_ref(w)
                s = s.contiguous()
                got = int8_matmul_cuda(x, wq, s)
                want = int8_matmul_ref(x, wq, s)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                big = want.float().abs().max().item()
                # f32: summation order; bf16: one ulp at the largest output
                tol = big * (1e-5 if xdt == torch.float32 else 2 ** -7)
                name = f"int8_matmul x={str(xdt)[6:]} M{m}xK{k}xN{n}"
                if not err <= tol or not torch.isfinite(got.float()).all():
                    fail(f"{name}: max_abs_err {err:.3g} > tol {tol:.3g}")
                if xdt != torch.bfloat16:
                    print(f"[kernel] {name}: max_abs_err {err:.3g} <= {tol:.3g}")
                    continue
                ms = time_ms(lambda: int8_matmul_cuda(x, wq, s))
                plain_ms = time_ms(lambda: int8_matmul_ref(x, wq, s))
                wd = (wq.float() * s[None, :]).to(xdt)
                lib_ms = time_ms(lambda: torch.matmul(x, wd))
                nbytes = m * k * _isz(x) + k * n + 4 * n + m * n * _isz(x)
                bms, by = bound(nbytes, 2 * m * n * k, _op_type(x))
                print(f"[kernel] {name}: max_abs_err {err:.3g} <= {tol:.3g}  "
                      f"ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms "
                      f"{bms:.5f} ({by})  library_ms(matmul) {lib_ms:.4f}")
                key = f"M{m}xK{k}xN{n}"
                results[("int8_matmul", key)] = dict(
                    name=f"int8_matmul[{key}]", route="cuda",
                    source="src/repro_torch/csrc/int8_matmul.cu",
                    replaces="src/repro/kernels/int8_matmul.py:66",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms)


def grad_leaf_blocks():
    """{leaf name: quantization blocks} of smollm-360m's gradient tree at
    full width, after `ops.quantize_blocks`' padding to whole 2048-value
    tiles (the JAX wrapper's shapes)."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.tree import tree_paths
    leaves = tree_paths(transformer.schema(get_config("smollm-360m")))
    return {k: -(-math.prod(d.shape) // 2048) * 8 for k, d in leaves.items()}


def _gradient_blocks(gen, nb):
    """(nb, 256) f32 values at a different scale in every block, as the
    gradient leaves are."""
    import torch
    scale = torch.exp(torch.randn(nb, 1, generator=gen, device="cuda") * 3)
    return torch.randn(nb, 256, generator=gen, device="cuda") * scale * 1e-3


def _quantizer_err(x2d):
    """Quantize x2d and dequantize (f32 and bf16) through the kernels and
    the plain versions; fail unless every int8 byte, scale and output is
    equal. NaN blocks: equal NaN scales, their undefined int8 values and
    NaN outputs skipped. Returns (q, s) of the kernel and the largest
    |kernel - plain| over the non-NaN blocks of quantize (int8 values and
    scales) and of dequantize (both output dtypes), or None."""
    import torch
    from repro_torch.kernels.quantize import (
        dequantize_blocks_cuda, quantize_blocks_cuda)
    from repro_torch.kernels.ref import dequantize_blocks_ref, quantize_blocks_ref
    q, s = quantize_blocks_cuda(x2d)
    wq, ws, _ = quantize_blocks_ref(x2d)
    torch.cuda.synchronize()
    nan = torch.isnan(ws)
    if not torch.equal(torch.isnan(s), nan) or not torch.equal(s[~nan], ws[~nan]) \
            or not torch.equal(q[~nan], wq[~nan]):
        return None
    q_err = max((q[~nan].int() - wq[~nan].int()).abs().max().item(),
                (s[~nan] - ws[~nan]).abs().max().item())
    d_err = 0.0
    for out in (torch.float32, torch.bfloat16):
        got = dequantize_blocks_cuda(q, s, out)
        want = dequantize_blocks_ref(q, s, q.numel(), q.shape, out)
        torch.cuda.synchronize()
        if not torch.equal(got[~nan], want[~nan]) \
                or not torch.isnan(got[nan].float()).all():
            return None
        d_err = max(d_err, (got[~nan].float() - want[~nan].float())
                    .abs().max().item())
    return q, s, float(q_err), d_err


def check_quantize_blocks(gen, results):
    """The gradient block quantizers at every full-width leaf shape: f32
    gradient-like blocks (the main path's input), a bf16 variant, an
    all-zero leaf, a tie block (absmax 127: scale 1.0, values k + 0.5) and
    a NaN block, each bit-equal to the plain version. Times per leaf shape
    and summed over the 11 leaves of one compressed step."""
    import torch
    from repro_torch.kernels.quantize import (
        dequantize_blocks_cuda, quantize_blocks_cuda)
    from repro_torch.kernels.ref import dequantize_blocks_ref, quantize_blocks_ref
    leaves = grad_leaf_blocks()
    step = {k: 0.0 for k in ("q_ms", "q_plain", "q_bound", "d_ms", "d_plain",
                             "d_bound", "d_lib")}
    timed = {}
    q_err = d_err = 0.0
    for name, nb in leaves.items():
        x = _gradient_blocks(gen, nb)
        cases = [("f32", x), ("bf16", x.to(torch.bfloat16))]
        if name == "final_norm":
            cases.append(("all-zero", torch.zeros_like(x)))
        if name == "layers/wk":
            special = x.clone()
            special[0] = torch.arange(256, device="cuda") % 127 - 63.5
            special[0, 0] = 127.0                              # tie block
            special[nb // 2, 77] = float("nan")                # NaN block
            cases.append(("tie+NaN blocks", special))
        for label, xin in cases:
            got = _quantizer_err(xin)
            if got is None:
                fail(f"quantize_blocks {name} ({nb} blocks) {label}: kernel "
                     "and plain version differ")
            q_err, d_err = max(q_err, got[2]), max(d_err, got[3])
            if label == "tie+NaN blocks" and (got[1][0].item() != 1.0
                                              or not torch.isnan(got[1][nb // 2])):
                fail(f"quantize_blocks {name}: tie scale {got[1][0].item()} "
                     "or NaN scale lost")
            if label == "all-zero" and got[0].any():
                fail("quantize_blocks all-zero leaf: nonzero int8 values")
        if nb not in timed:       # the main path's f32 input, timed per shape
            q, s = quantize_blocks_cuda(x)
            sc = s[:, None]
            t = dict(
                q_ms=time_ms(lambda: quantize_blocks_cuda(x)),
                q_plain=time_ms(lambda: quantize_blocks_ref(x)),
                d_ms=time_ms(lambda: dequantize_blocks_cuda(q, s)),
                d_plain=time_ms(lambda: dequantize_blocks_ref(
                    q, s, q.numel(), q.shape)),
                d_lib=time_ms(lambda: torch.mul(q, sc)))
            # bytes: quantize reads f32 and writes int8 + one f32 scale per
            # block; dequantize the reverse. ~10 ops per element, far below
            # the f32 rate either way
            nbytes = nb * 256 * (4 + 1) + nb * 4
            t["q_bound"], by = bound(nbytes, 10 * nb * 256, "f32")
            t["d_bound"], _ = bound(nbytes, 2 * nb * 256, "f32")
            timed[nb] = (t, by)
        t, by = timed[nb]
        for k in step:
            step[k] += t[k]
        print(f"[kernel] quantize_blocks {name} ({nb} blocks): f32/bf16"
              f"{'/zero' if name == 'final_norm' else ''}"
              f"{'/tie/NaN' if name == 'layers/wk' else ''} bit-equal; "
              f"ms {t['q_ms']:.4f} plain_ms {t['q_plain']:.4f} bound_ms "
              f"{t['q_bound']:.5f} ({by}) library_ms null | dequantize ms "
              f"{t['d_ms']:.4f} plain_ms {t['d_plain']:.4f} bound_ms "
              f"{t['d_bound']:.5f} library_ms(mul) {t['d_lib']:.4f}")
    total_blocks = sum(leaves.values())
    print(f"[kernel] block quantizers per compressed step ({len(leaves)} "
          f"leaves, {total_blocks} blocks): quantize ms {step['q_ms']:.4f} "
          f"plain_ms {step['q_plain']:.4f} bound_ms {step['q_bound']:.4f}; "
          f"dequantize ms {step['d_ms']:.4f} plain_ms {step['d_plain']:.4f} "
          f"bound_ms {step['d_bound']:.4f} library_ms(mul) {step['d_lib']:.4f}")
    print(f"[kernel] block quantizers max |kernel - plain| over every case: "
          f"quantize {q_err} dequantize {d_err}")
    common = dict(route="cuda", source="src/repro_torch/csrc/quantize_blocks.cu",
                  bound_by="bytes")
    results[("quantize_blocks", "step")] = dict(
        common, max_abs_err=q_err,
        name=f"quantize_blocks[{len(leaves)} grad leaves/step]",
        replaces="src/repro/kernels/quantize.py:43", ms=step["q_ms"],
        plain_ms=step["q_plain"], bound_ms=step["q_bound"], library_ms=None)
    results[("dequantize_blocks", "step")] = dict(
        common, max_abs_err=d_err, name=f"dequantize_blocks[{len(leaves)} grad leaves/step]",
        replaces="src/repro/kernels/quantize.py:63", ms=step["d_ms"],
        plain_ms=step["d_plain"], bound_ms=step["d_bound"],
        library_ms=step["d_lib"])


# ---------------------------------------------------------------------------
# phase 3: serve smollm-360m at full width
# ---------------------------------------------------------------------------

def serve_traffic():
    """12 prompts, lengths in [32, 768] from default_rng(0), one of them not
    a multiple of the 64-token chunk."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.integers(32, 769, SERVE_REQUESTS)]
    if all(n % SMOLLM["chunk"] == 0 for n in lens):
        lens[-1] = 741
    prompts = [rng.integers(0, 49152, n).astype(np.int32) for n in lens]
    return lens, prompts


def reset_counts():
    from repro_torch.kernels import (
        decode_attention, flash_attention, int8_matmul, quantize)
    for mod in (decode_attention, flash_attention, int8_matmul, quantize):
        mod.LAUNCHES.clear()


def read_counts():
    from repro_torch.kernels import (
        decode_attention, flash_attention, int8_matmul, quantize)
    return {"decode_attention": dict(decode_attention.LAUNCHES),
            "flash_attention_paged": dict(flash_attention.LAUNCHES),
            "int8_matmul": dict(int8_matmul.LAUNCHES),
            "quantize_blocks": quantize.LAUNCHES["quantize_blocks"],
            "dequantize_blocks": quantize.LAUNCHES["dequantize_blocks"]}


def check_teacher_forced(eng, reqs, label):
    """Re-run prompt + emitted tokens through the cacheless `forward_hidden`
    (plain attention on the card) and compare each decode step's logits with
    the engine's. Tolerance TF_TOL = 0.1: both paths carry bf16 activations
    through 32 layers (2^-8 relative rounding per op, in other orders), and
    random-init logits have a std near 0.6; a wrong attention or cache row
    moves logits by that std. The argmax must agree wherever the teacher-
    forced top-1 margin exceeds the tolerance."""
    import numpy as np
    import torch
    from repro_torch.models import transformer
    cfg = eng.cfg
    kv_round = None if eng.kv_dtype == torch.float32 else eng.kv_dtype
    for r in reqs:
        plen, n = r.prompt.shape[0], len(r.out_tokens)
        toks = np.concatenate([r.prompt, np.asarray(r.out_tokens[:-1], np.int32)])
        with torch.no_grad():
            hidden, _ = transformer.forward_hidden(
                eng.params, torch.as_tensor(toks, device="cuda")[None].int(),
                cfg, mode="prefill", kv_round=kv_round)
            ref = transformer.lm_logits(eng.params, hidden[:, plen - 1:plen - 1 + n],
                                        cfg)[0, :, :cfg.vocab_size].float().cpu()
        got = torch.stack(r.logits)
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"{label}: engine logits {tuple(got.shape)} vs {tuple(ref.shape)}")
        err = (got - ref).abs().max().item()
        top2 = ref.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > TF_TOL
        agree = got.argmax(-1) == ref.argmax(-1)
        print(f"[serve] {label} teacher-forced rid={r.rid} plen={plen} "
              f"steps={n}: max|dlogit| {err:.4f} (tol {TF_TOL}), argmax "
              f"agrees {int(agree.sum())}/{n}, {int(sure.sum())} steps with "
              f"margin > tol all agree: {bool(agree[sure].all())}")
        if err > TF_TOL or not bool(agree[sure].all()):
            fail(f"{label}: teacher-forced logits disagree (rid {r.rid})")


def contraction_fan_in(params, cfg):
    """Rescale the attention projections of an `init_params` draw to unit
    gain over their contraction fan-in.

    The schema init (kept from the JAX package for parity) takes a weight's
    fan-in as `shape[-2]`, which for the (d, heads, head_dim) projections is
    the head count: at smollm-360m's full width q and k then have std ~8 and
    ~14, softmax is an argmax and the random model is chaotic (a reordered
    f32 sum moves its logits by O(1); `tools/torch_init_scale.py`). Scaled
    to fan-in d (heads x head_dim for wo), q and k have std ~1. Returns a
    new dict; the inputs are not modified."""
    hd = cfg.n_heads * cfg.head_dim
    gain = {"wq": cfg.n_heads / cfg.d_model, "wk": cfg.n_kv_heads / cfg.d_model,
            "wv": cfg.n_kv_heads / cfg.d_model, "wo": cfg.head_dim / hd}
    layers = {k: v * gain[k] ** 0.5 if k in gain else v
              for k, v in params["layers"].items()}
    return dict(params, layers=layers)


def _engine(model, params, keep_logits, **engine_kw):
    from repro_torch.serve.engine import ServeEngine
    c = SMOLLM
    return ServeEngine(model, n_slots=c["slots"], max_len=c["max_len"],
                       params=params, page_size=c["page"],
                       chunk_pages=c["chunk"] // c["page"],
                       keep_logits=keep_logits, **engine_kw)


def serve_run(model, params, label, **engine_kw):
    """Serve the traffic on an engine that keeps no logits (the timed run,
    one host sync per step), then serve three of its requests again on one
    that keeps them, for the teacher-forced check."""
    import torch
    c = SMOLLM
    lens, prompts = serve_traffic()
    eng = _engine(model, params, False, **engine_kw)
    reqs = [eng.submit(p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    reset_counts()                      # counts of the main path's run only
    t0 = time.perf_counter()
    stats = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    s = stats.summary()
    print(f"[serve] {label}: prompt lengths {lens}")
    print(f"[serve] {label}: {stats.tokens_out} tokens in {wall:.3f} s = "
          f"{stats.tokens_out / wall:.1f} tokens/s; TTFT p50 "
          f"{s['ttft_p50_s']:.4f} s p99 {s['ttft_p99_s']:.4f} s; TPOT p50 "
          f"{s['tpot_p50_s']:.4f} s; decode_steps {stats.decode_steps} "
          f"prefill_chunks {stats.prefill_chunks} peak_pages "
          f"{stats.peak_pages_in_use}")
    print(f"[serve] {label}: launches {json.dumps(counts)}")
    if not all(r.done and len(r.out_tokens) == SERVE_NEW_TOKENS for r in reqs):
        fail(f"{label}: not every request finished")
    eng.assert_accounting()
    if stats.pages_in_use != 0 or eng.pages_allocatable() != eng.n_pages - 1:
        fail(f"{label}: pages still in use at the end")
    pool = "int8" if engine_kw.get("kv_dtype") == "int8" else "f32"
    dec = counts["decode_attention"]
    chk = counts["flash_attention_paged"]
    if dec != {f"paged/{pool}": stats.decode_steps * N_LAYERS}:
        fail(f"{label}: decode launches {dec} != decode_steps x {N_LAYERS}")
    if chk != {pool: stats.prefill_chunks * N_LAYERS}:
        fail(f"{label}: chunk launches {chk} != prefill_chunks x {N_LAYERS}")
    mm = counts["int8_matmul"]
    if engine_kw.get("wdtype") == "int8":
        # per layer: wq, wk, wv, wo, w1, w3, w2 (at full width wq/wo are
        # 960→960, wk/wv 960→320, w1/w3 960→2560, w2 2560→960): every
        # projection of every step on the kernel
        cfg = eng.cfg
        d, hd, f = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff
        kvd = cfg.n_kv_heads * cfg.head_dim
        want = {}
        for m, steps in ((c["slots"], stats.decode_steps),
                         (c["chunk"], stats.prefill_chunks)):
            for k, n in ((d, hd), (d, kvd), (d, kvd), (hd, d), (d, f),
                         (d, f), (f, d)):
                key = f"M{m}xK{k}xN{n}"
                want[key] = want.get(key, 0) + steps * N_LAYERS
        if mm != want:
            fail(f"{label}: int8_matmul launches {mm} != {want}")
    elif mm:
        fail(f"{label}: int8_matmul launched without int8 weights")
    picks = [min(reqs, key=lambda r: r.prompt.shape[0]),
             next(r for r in reqs if r.prompt.shape[0] % c["chunk"]),
             max(reqs, key=lambda r: r.prompt.shape[0])]
    picks = list({r.rid: r for r in picks}.values())
    tf0 = time.perf_counter()
    tf_eng = _engine(model, params, True, **engine_kw)
    tf_reqs = [tf_eng.submit(r.prompt, max_new_tokens=SERVE_NEW_TOKENS)
               for r in picks]
    tf_eng.run_to_completion()
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(picks, tf_reqs))
    print(f"[serve] {label}: the logit-keeping engine emitted the timed "
          f"run's tokens for {same}/{len(picks)} requests")
    check_teacher_forced(tf_eng, tf_reqs, label)
    print(f"[serve] {label}: phase seconds serve {wall:.2f} teacher-forced "
          f"{time.perf_counter() - tf0:.2f}")
    return counts


def serve_phase():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config("smollm-360m")          # full width: 32 x 960, 15/5 heads
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.vocab_size) == (N_LAYERS, 960, 15, 5, 49152)
    model = build_model(cfg)                 # device=None → cuda
    t0 = time.perf_counter()
    # bf16 from a seeded Generator, attention projections rescaled to their
    # contraction fan-in: at the schema's own init the random model is
    # chaotic and no logit comparison could test the kernels
    params = contraction_fan_in(model.init(seed=0), cfg)
    torch.cuda.synchronize()
    print(f"[serve] init {cfg.name} full width on {model.device}: "
          f"{time.perf_counter() - t0:.2f} s")
    counts_a = serve_run(model, params, "(a) bf16 weights, f32 KV")
    counts_b = serve_run(model, params, "(b) int8 weights, int8 KV",
                         wdtype="int8", kv_dtype="int8")
    return counts_a, counts_b


# ---------------------------------------------------------------------------
# phase 4: train smollm-360m at full width
# ---------------------------------------------------------------------------

TRAIN = dict(arch="smollm-360m", smoke=False, global_batch=8, seq_len=512,
             ckpt_every=0, log_every=1, seed=0)
TRAIN_STEPS = 6
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")


class _Tee:
    """stdout that is also kept, for the train loop's per-step log lines."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_train_loop(label, **kw):
    """The port's `train_loop` on the card; returns (losses, state, counts,
    {step: logged ms}). Every launch counter is 0 just before the run."""
    import re
    import torch
    from repro_torch.launch.train import train_loop
    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        losses, state = train_loop(**{**TRAIN, **kw})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    step_ms = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"\[train\] step +(\d+) .* ([0-9.]+) ms", "".join(tee.lines))}
    print(f"[train] {label}: {len(losses)} steps in {wall:.2f} s (incl. "
          f"init/restore and the final save); losses "
          f"{[round(v, 4) for v in losses]}; launches {json.dumps(counts)}")
    return losses, state, counts, step_ms


@contextlib.contextmanager
def plain_block_quantizers():
    """Route the block-quantizer wrappers to their plain versions on CUDA
    tensors, for the kernel-versus-plain check on a real gradient tree."""
    from repro_torch.kernels import quantize as kq
    from repro_torch.kernels.ref import dequantize_blocks_ref, quantize_blocks_ref
    saved = kq.quantize_blocks_cuda, kq.dequantize_blocks_cuda
    kq.quantize_blocks_cuda = lambda x: quantize_blocks_ref(x)[:2]
    kq.dequantize_blocks_cuda = lambda q, s, out_dtype: dequantize_blocks_ref(
        q, s, q.numel(), q.shape, out_dtype)
    try:
        yield
    finally:
        kq.quantize_blocks_cuda, kq.dequantize_blocks_cuda = saved


def _bits(t):
    import torch
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def check_real_gradients():
    """Step 0's gradient tree (seed 0, batch 0, the loop's remat and CE
    chunk): `compress_decompress` through the kernels must equal the same
    call through the plain versions bit for bit. Returns its device ms."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.kernels import quantize as kq
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.registry import build_model
    from repro_torch.train import compression
    from repro_torch.tree import tree_map, tree_paths
    cfg = get_config(TRAIN["arch"])
    if TRAIN["smoke"]:
        cfg = cfg.smoke()
    model = build_model(cfg)
    params = model.init(TRAIN["seed"])
    batch = TokenSource(DataConfig(cfg.vocab_size, TRAIN["seq_len"],
                                   TRAIN["global_batch"])).batch_at(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    loss, grads = steps_mod.loss_and_grads(
        model, params, batch, ce_chunk=min(128, TRAIN["seq_len"]), remat="full")
    grads = tree_map(lambda g: g.float(), grads)
    del params
    ghat, err = compression.compress_decompress(grads)
    before = dict(kq.LAUNCHES)
    with plain_block_quantizers():
        ghat_p, err_p = compression.compress_decompress(grads)
    torch.cuda.synchronize()
    if dict(kq.LAUNCHES) != before:
        fail("the plain compress_decompress launched a kernel")
    for name, (a, b) in {"ghat": (ghat, ghat_p), "err": (err, err_p)}.items():
        pa, pb = tree_paths(a), tree_paths(b)
        for k in pa:
            if not torch.equal(_bits(pa[k]), _bits(pb[k])):
                fail(f"compress_decompress {name}[{k}]: kernels and plain "
                     "versions differ on the real gradient tree")
    n = sum(g.numel() for g in tree_paths(grads).values())
    gnorm = torch.sqrt(sum((g * g).sum() for g in tree_paths(grads).values()))
    ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compression.compress_decompress(grads)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    comp_ms = sum(ms[1:]) / len(ms[1:])
    print(f"[train] real gradient tree of step 0 (loss {float(loss):.4f}, "
          f"{len(tree_paths(grads))} leaves, {n} values, |g| "
          f"{float(gnorm):.4f}): compress_decompress through the kernels is "
          f"bit-equal to the plain versions (ghat and err); "
          f"{comp_ms:.3f} ms per call (host clock, synchronized)")
    return comp_ms


STEP_CHECK = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)


def check_step_on_card():
    """One `make_train_step` of smollm-360m `.smoke()` (f32, attention
    projections at their contraction fan-in, seq 32 x batch 4, remat 'full')
    on the card against the same step on the CPU from the same state, with
    compression off and on and n_micro 1 and 2, at the tolerances of the CPU
    parity test `tests/test_torch_train.py::test_train_step_matches_jax`:
    loss, grad_norm and lr within 1e-5 relative; params within 1e-2·lr +
    1e-5 relative, m and v within 1e-8 + 1e-5 relative; with compression at
    most 0.1 % of a leaf off (a gradient on a rounding boundary of its int8
    block moves by one quantum) and each by at most what one quantum does.
    No warmup and lr 1e-3 (eps 1e-3, as the test: a gradient within
    rounding of zero steps by an arbitrary fraction of lr at eps 1e-8):
    every param moves by up to 1e-3, a hundred times the tolerance, and m
    holds the clipped gradient itself, so a wrong AdamW, clip or compressed
    gradient fails here, where the full-width run's warmup steps and its
    clipped ~1e16 gradient norms cannot show it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.registry import build_model
    from repro_torch.train import compression
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.tree import tree_map, tree_paths
    seq, batch_size = 32, 4
    cfg = get_config(TRAIN["arch"]).smoke()
    ocfg = opt_mod.OptimizerConfig(**STEP_CHECK)
    lr = STEP_CHECK["peak_lr"]
    legs = {"cpu": build_model(cfg, device="cpu"),       # the reference
            "card": build_model(cfg)}                  # → cuda
    params = contraction_fan_in(legs["cpu"].init(seed=TRAIN["seed"]), cfg)
    batch = TokenSource(DataConfig(cfg.vocab_size, seq, batch_size)).batch_at(2)
    checks = (("params", lambda s: s["params"], 1e-2 * lr, lambda w: 2 * lr),
              ("m", lambda s: s["opt"]["m"], 1e-8,
               lambda w: w.abs().max() / 127),
              ("v", lambda s: s["opt"]["v"], 1e-8,
               lambda w: 3 * w.abs().max() / 127))
    report = []
    for compress in (False, True):
        gt = (lambda g: compression.compress_decompress(g)[0]) \
            if compress else None
        for n_micro in (1, 2):
            label = f"compress={compress} n_micro={n_micro}"
            new, met = {}, {}
            for leg, model in legs.items():
                p = tree_map(lambda t: t.clone().to(model.device), params)
                step = steps_mod.make_train_step(
                    model, ocfg, gt, n_micro=n_micro, ce_chunk=seq,
                    remat="full")
                new[leg], met[leg] = step(
                    {"params": p, "opt": opt_mod.init_opt_state(p)},
                    {k: torch.as_tensor(v, device=model.device)
                     for k, v in batch.items()})
            rel = {}
            for k in ("loss", "grad_norm", "lr"):
                got, want = float(met["card"][k]), float(met["cpu"][k])
                rel[k] = abs(got - want) / abs(want)
                if not rel[k] <= 1e-5:
                    fail(f"train step on the card, {label}: {k} {got} vs "
                         f"the CPU's {want}")
            n_off = 0
            for name, get, atol, quantum in checks:
                want_t, got_t = tree_paths(get(new["cpu"])), tree_paths(
                    get(new["card"]))
                for key, w in want_t.items():
                    d = (got_t[key].cpu() - w).abs()
                    tol = atol + 1e-5 * w.abs()
                    off = d > tol
                    n = int(off.sum())
                    if n and (not compress or n > max(1, off.numel() // 1000)
                              or bool((d[off] > quantum(w)).any())):
                        fail(f"train step on the card, {label}: {name}[{key}] "
                             f"{n} of {off.numel()} values off, max "
                             f"|diff| {d.max().item():.3e}")
                    n_off += n
                    rel[name] = max(rel.get(name, 0.0),
                                    float((d[~off] / tol[~off]).max()))
            if int(new["card"]["opt"]["step"]) != 1:
                fail(f"train step on the card, {label}: opt step "
                     f"{int(new['card']['opt']['step'])}")
            report.append(f"{label}: loss {float(met['card']['loss']):.5f} "
                          f"grad_norm {float(met['card']['grad_norm']):.5f}, "
                          f"rel diff loss {rel['loss']:.1e} grad_norm "
                          f"{rel['grad_norm']:.1e}; max |diff| / tolerance "
                          f"params {rel['params']:.1e} m {rel['m']:.1e} v "
                          f"{rel['v']:.1e} over all values but the {n_off} "
                          "a quantum off")
    for line in report:
        print(f"[train] one step of {cfg.name} on the card vs the CPU, "
              f"{line}")


def train_phase():
    """One smoke-size train step on the card held to the same step on the
    CPU (`check_step_on_card`), then smollm-360m at full width (bf16
    params, f32 m/v), global batch 8 x seq 512, 6 steps of the port's
    `train_loop` on the card: uncompressed,
    then with `compress_grads`, then a resume of the compressed run to step
    8 from its own checkpoint. Returns the compressed run's launch counts."""
    import shutil
    import torch
    import numpy as np
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.tree import tree_paths
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    check_step_on_card()
    comp_ms = check_real_gradients()
    torch.cuda.empty_cache()
    n_leaves = len(grad_leaf_blocks())
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]

    plain_dir = os.path.join(TRAIN_DIR, "plain")
    plain, pstate, pcounts, pms = run_train_loop(
        "uncompressed", steps=TRAIN_STEPS, ckpt_dir=plain_dir)
    shutil.rmtree(plain_dir)
    t0 = time.perf_counter()
    CheckpointManager(plain_dir).save(TRAIN_STEPS - 1, pstate)
    save_s = time.perf_counter() - t0
    shutil.rmtree(plain_dir)
    del pstate
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    comp_dir = os.path.join(TRAIN_DIR, "compressed")
    comp, cstate, ccounts, cms = run_train_loop(
        "compressed grads", steps=TRAIN_STEPS, ckpt_dir=comp_dir,
        compress_grads=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for label, losses in (("uncompressed", plain), ("compressed", comp)):
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            fail(f"train {label}: losses {losses}")
    gap = abs(float(np.mean(comp)) - float(np.mean(plain)))
    if not gap < 0.5:
        fail(f"train: mean losses differ by {gap:.4f} (bound 0.5)")
    want = n_leaves * TRAIN_STEPS
    for label, counts, q in (("uncompressed", pcounts, 0),
                             ("compressed", ccounts, want)):
        if counts["quantize_blocks"] != q or counts["dequantize_blocks"] != q:
            fail(f"train {label}: block-quantizer launches {counts} != {q}")
        if counts["decode_attention"] or counts["flash_attention_paged"] \
                or counts["int8_matmul"]:
            fail(f"train {label}: serving kernels launched {counts}")

    # restore the compressed run's own bf16 checkpoint: bit-equal state
    mgr = CheckpointManager(comp_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, manifest = mgr.restore(device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if manifest["step"] != TRAIN_STEPS - 1:
        fail(f"train: latest checkpoint is step {manifest['step']}")
    got, want_state = tree_paths(restored), tree_paths(cstate)
    if set(got) != set(want_state) or any(
            got[k].dtype != v.dtype or not torch.equal(_bits(got[k]), _bits(v))
            for k, v in want_state.items()):
        fail("train: the restored checkpoint differs from the run's state")
    dtypes = sorted({str(v.dtype)[6:] for v in tree_paths(restored["params"]).values()})
    del restored, cstate
    torch.cuda.empty_cache()

    resumed, _, rcounts, rms = run_train_loop(
        "resume", steps=TRAIN_STEPS + 2, ckpt_dir=comp_dir, compress_grads=True)
    if len(resumed) != 2 or sorted(rms) != [TRAIN_STEPS, TRAIN_STEPS + 1] \
            or not all(np.isfinite(resumed)):
        fail(f"train resume: ran steps {sorted(rms)}, losses {resumed}")
    if rcounts["quantize_blocks"] != 2 * n_leaves:
        fail(f"train resume: launches {rcounts}")
    if mgr.latest_step() != TRAIN_STEPS + 1 or not mgr.verify(TRAIN_STEPS + 1):
        fail("train resume: no verified checkpoint at the last step")
    shutil.rmtree(TRAIN_DIR)

    steady = range(1, TRAIN_STEPS)
    p_ms = sum(pms[s] for s in steady) / len(steady)
    c_ms = sum(cms[s] for s in steady) / len(steady)
    print(f"[train] params {dtypes}; restored step {manifest['step']} "
          f"bit-equal to the run's state; the resume ran steps "
          f"{sorted(rms)}, losses {[round(v, 4) for v in resumed]}, verified")
    print(f"[train] ms/step (steps 1-{TRAIN_STEPS - 1}, host clock incl. the "
          f"loss sync): uncompressed {p_ms:.1f} = {tokens / p_ms * 1e3:.0f} "
          f"tokens/s; compressed {c_ms:.1f} = {tokens / c_ms * 1e3:.0f} "
          f"tokens/s; compress_decompress {comp_ms:.2f} ms = "
          f"{comp_ms / c_ms:.4f} of a compressed step; |mean loss gap| "
          f"{gap:.4f} (< 0.5); checkpoint save {save_s:.2f} s restore "
          f"(verify incl.) {restore_s:.2f} s; peak device memory "
          f"{peak_gb:.2f} GB")
    return ccounts


# ---------------------------------------------------------------------------

def main():
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: nothing to measure", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build   # fails outside a checkout

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"[build] {len(_build.SOURCES)} kernels built in "
          f"{_build.build():.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    t0 = time.perf_counter()
    lens, _ = serve_traffic()
    # the decode batch's kv_len: 8 slots, 16 tokens into decoding, plus a
    # slot at the 1024-row edge
    decode_lens = [n + 16 for n in lens[:SMOLLM["slots"] - 1]] + [1024]
    check_decode(gen, results, decode_lens)
    check_chunk(gen, results)
    check_int8_matmul(gen, results)
    check_quantize_blocks(gen, results)
    print(f"[chip_smoke] kernel phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    t1 = time.perf_counter()
    counts_a, counts_b = serve_phase()
    print(f"[chip_smoke] serve phase {time.perf_counter() - t1:.1f} s",
          flush=True)
    t2 = time.perf_counter()
    counts_train = train_phase()
    print(f"[chip_smoke] train phase {time.perf_counter() - t2:.1f} s",
          flush=True)
    for (kernel, key), entry in results.items():
        if kernel in ("quantize_blocks", "dequantize_blocks"):
            entry["launches"] = counts_train[kernel]
        else:
            counts = counts_b if key in ("paged/int8", "int8") \
                or kernel == "int8_matmul" else counts_a
            entry["launches"] = counts[kernel].get(key, 0)
        if entry["launches"] == 0:
            fail(f"{entry['name']} was never launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in results.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
