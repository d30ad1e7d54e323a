"""Weight-only int8 pass, quantization-aware einsum and int8 KV rows (port of
`repro/models/quantized.py`: the dense, moe, vlm and encdec families, GQA or
MLA attention).

Quantized leaves are plain dicts `{"int8_q": int8, "s": f32}`; `s` keeps the
weight's rank with contraction dims reduced to 1. `qeinsum` sends float
weights to `torch.einsum` and quantized ones through the port's
`int8_matmul` (the CUDA kernel on CUDA tensors, its plain version on CPU
ones) after reshaping to 2-D exactly as the JAX `_try_pallas` does; MoE
expert weights, whose leading expert dim all three operands share, go to
`int8_matmul_batched` (one launch for every expert) where JAX vmaps the
kernel. There is no `blocks_fit` gate: the kernel masks ragged tiles itself.

Float projections on the card go through `fixed_row_blocks`: the library's
matrix product picks its kernel, and with it a row's summation order
(split-K or not), by the number of rows, so a prompt row projected in a
64-row chunk, a 1024-row bucket, a 658-row or a 12-row exact-length
prefill, or a decode row beside 7 others or alone, could round otherwise.
In fixed row blocks every row of one kind of step meets the same product:
decode steps (`decode_products()`) 16 rows, every other step 64.
`int8_matmul` picks its path by the row count too (GEMV up to 16 rows), so
outside a decode step a prefill of at most 16 bf16 rows is padded into
the tensor-core path that chunks take. Products whose row count never
changes (the encoder-decoder's encoder and its cross K/V, always
`cross_len` rows) run as one call under `one_product()`: at
seamless-m4t-medium's full width with bf16 weights an admission's
`prefill_cross` then takes 999 launches and 22 ms, against 8,679 and
218 ms in 64-row blocks (`tools/torch_encoder_products.py`, NVIDIA H100
80GB HBM3 at 700 W). Quantized weights never take the row blocks.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Tuple

import torch

from repro_torch.kernels.int8_matmul import (
    GEMV_MAX_M, int8_matmul, int8_matmul_batched)
from repro_torch.kernels.ref import quantize_channelwise_ref
from repro_torch.models.common import init_params_by_layer, stack_slices

_QKEY = "int8_q"

# param key → contraction axes of the layer-stacked weight (axis 0 = layers)
_ATTN_AXES = {"wq": (1,), "wk": (1,), "wv": (1,), "wo": (1, 2)}
# MLA (models/mla.py): the d_model-sized projections quantize like GQA's;
# the absorbed per-head up-projections wk_b/wv_b stay float, as in the JAX
# package (plain einsums inside the latent attention)
_MLA_AXES = {"wq": (1,), "wq_a": (1,), "wq_b": (1,), "wkv_a": (1,),
             "wo": (1, 2)}
_FFN_AXES = {"w1": (1,), "w3": (1,), "w2": (1,)}
# MoE expert weights (L, E, ...) contract over axis 2, so the scale keeps the
# expert dim: per-expert channels; shared experts quantize like a dense FFN
_MOE_AXES = {"w1": (2,), "w3": (2,), "w2": (2,),
             "shared_w1": (1,), "shared_w3": (1,), "shared_w2": (1,)}
# the encoder-decoder's cross-attention projections (decoder layers)
_CROSS_AXES = {"c" + k: v for k, v in _ATTN_AXES.items()}

SCALE_DTYPE = torch.float16   # int8 KV scale storage (one per row, kv head)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and _QKEY in w


def quantize_weight_channelwise(w: torch.Tensor, axes: Tuple[int, ...]
                                ) -> Dict[str, torch.Tensor]:
    q, s = quantize_channelwise_ref(w, axes)
    return {_QKEY: q, "s": s}


def _quantize_slices(slices, shape, axes: Tuple[int, ...], device):
    """`quantize_weight_channelwise` of a layer-stacked leaf of `shape`
    given as its layer slices, one at a time: the scale is per (layer,
    channel) and never reduces over axis 0, so the bits are those of the
    whole-leaf pass, while the f32 temporaries are one layer's (a (24, 60,
    2048, 1408) expert leaf would need 16.6 GB of them at once)."""
    inner = tuple(a - 1 for a in axes)
    q = torch.empty(shape, dtype=torch.int8, device=device)
    scales = []
    for i, w in enumerate(slices):
        q[i], sc = quantize_channelwise_ref(w, inner)
        scales.append(sc)
    return {_QKEY: q, "s": torch.stack(scales)}


def _quant_table(cfg) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """{group of layer-stacked leaves: {leaf: contraction axes}} of the
    leaves `quantize_params` quantizes for `cfg`: "layers" for the
    decoder-only families, "enc" and "dec" for the encoder-decoder. The
    recurrent families have no int8 datapath and raise ValueError, as the
    reference's `quantize_params` does."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(f"int8 weights apply to attention families, not "
                         f"{cfg.family!r}")
    if cfg.family not in ("dense", "moe", "vlm", "encdec") \
            or cfg.attn_kind not in ("gqa", "mla"):
        raise NotImplementedError(
            f"int8 weights for family {cfg.family!r}/{cfg.attn_kind!r} come "
            "with ROADMAP A10 (remaining model families)")
    if cfg.family == "encdec":
        return {"enc": dict(_ATTN_AXES, **_FFN_AXES),
                "dec": dict(_ATTN_AXES, **_FFN_AXES, **_CROSS_AXES)}
    table = dict(_MLA_AXES if cfg.attn_kind == "mla" else _ATTN_AXES)
    table.update(_MOE_AXES if cfg.family == "moe" else _FFN_AXES)
    return {"layers": table}


def quantize_params(params, cfg):
    """Weight-only int8 over the layer QKV/O projections (MLA: the
    `_MLA_AXES` projections) and the FFN: the dense FFN, or for the moe
    family every routed expert (per expert) and the shared expert; encdec:
    the encoder's and the decoder's self-attention and FFN and the
    decoder's cross-attention projections. Embeddings, norms, biases, the
    router, the shared expert's gate, MLA's wk_b/wv_b and the LM head stay
    as they are. A leaf that is already `{int8_q, s}` passes through as it
    is (no copy)."""
    out = dict(params)
    for group, table in _quant_table(cfg).items():
        out[group] = {k: (_quantize_slices(v, v.shape, table[k], v.device)
                          if k in table and not is_quantized(v) else v)
                      for k, v in params[group].items()}
    return out


def init_int8_by_layer(schema, gen: torch.Generator, cfg,
                       dtype=torch.bfloat16, device=None, transform=None):
    """`quantize_params(init_params_by_layer(schema, gen, dtype, device,
    transform), cfg)`, bit for bit, without the float tree: each layer
    slice of a quantized leaf is drawn, transformed and quantized before
    the next is drawn, so the peak is the int8 tree so far plus one layer
    slice's temporaries (qwen2.5-32b at full width: about 35 GB, where the
    float tree alone is 65.5 GB in bf16)."""
    table = _quant_table(cfg)

    def build(path, d, slices, dt, dev):
        if len(path) == 2 and path[1] in table.get(path[0], ()):
            return _quantize_slices(slices, d.shape, table[path[0]][path[1]],
                                    dev)
        return stack_slices(path, d, slices, dt, dev)

    return init_params_by_layer(schema, gen, dtype, device, transform, build)


def _parse(eq: str):
    lhs, out = eq.replace(" ", "").split("->")
    xs, ws = lhs.split(",")
    contract = [c for c in ws if c not in out]
    batch = [c for c in ws if c in xs and c in out]
    wout = [c for c in ws if c in out and c not in batch]
    return xs, ws, out, "".join(contract), "".join(batch), "".join(wout)


# rows of one product on the card: a decode step's rows (the slots) run in
# DECODE_ROWS pieces, every other step's in ROW_BLOCK pieces (the serving
# chunk), the last one padded
DECODE_ROWS = 16
ROW_BLOCK = 64
_ONE_PRODUCT = contextvars.ContextVar("one_product", default=False)
_DECODE = contextvars.ContextVar("decode_products", default=False)


@contextlib.contextmanager
def decode_products():
    """Inside, the products are a decode step's: `fixed_row_blocks` cuts
    them in DECODE_ROWS pieces and int8_matmul takes its GEMV path at up
    to 16 rows, as the step's rows (the slots) ask; outside, every product
    is a prefill's or a chunk's (ROW_BLOCK pieces, the tensor-core path),
    whatever its row count."""
    token = _DECODE.set(True)
    try:
        yield
    finally:
        _DECODE.reset(token)


@contextlib.contextmanager
def one_product():
    """Inside, `fixed_row_blocks` computes each product as one call over
    all its rows. For products whose row count is always the same (the
    encoder-decoder's encoder and cross K/V: `cross_len` rows whichever
    path runs them) one call fixes a row's bits as row blocks would, with
    one launch where blocks take M / ROW_BLOCK."""
    token = _ONE_PRODUCT.set(True)
    try:
        yield
    finally:
        _ONE_PRODUCT.reset(token)


def fixed_row_blocks(x: torch.Tensor, mm) -> torch.Tensor:
    """mm(x) for 2-D x (M, K), computed as mm of fixed-size row blocks on a
    CUDA tensor with no autograd graph to record (the serving paths), so
    that a row's result does not depend on M; elsewhere, and inside
    `one_product()`, mm(x) itself."""
    if not x.is_cuda or (torch.is_grad_enabled() and x.requires_grad) \
            or _ONE_PRODUCT.get():
        return mm(x)
    m = x.shape[0]
    rows = DECODE_ROWS if _DECODE.get() else ROW_BLOCK
    pad = (-m) % rows
    xp = torch.cat([x, x.new_zeros(pad, x.shape[1])]) if pad else x
    return torch.cat([mm(xp[i:i + rows]) for i in range(0, m + pad, rows)
                      ])[:m]


def _plan_2d(eq: str, x: torch.Tensor, w_shape):
    """(batch letters, M, K, N, output shape) of a qeinsum pattern: x =
    [batch] <x-out><contract>, w = [batch] <contract><w-out>, out = [batch]
    <x-out><w-out>."""
    xs, ws, out, c, b, wout = _parse(eq)
    if len(b) == 1 and xs[0] == ws[0] == out[0] == b:
        xs, ws, out = xs[1:], ws[1:], out[1:]
    elif b:
        raise NotImplementedError(f"qeinsum pattern {eq!r}: batch dims {b!r}")
    x_out = xs[:len(xs) - len(c)]
    if not c or not xs.endswith(c) or ws != c + wout \
            or out != x_out + wout:
        raise NotImplementedError(f"qeinsum pattern {eq!r}")
    lead = x.shape[:len(b)]                     # the expert dim, or ()
    xe = x.shape[len(b):]
    m = 1
    for d in xe[:len(x_out)]:
        m *= d
    k = 1
    for d in xe[len(x_out):]:
        k *= d
    we = w_shape[len(b):]
    n = 1
    for d in we[len(c):]:
        n *= d
    return b, m, k, n, (*lead, *xe[:len(x_out)], *we[len(c):])


def qeinsum(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """`torch.einsum(eq, x, w)` where `w` may be a quantized `{int8_q, s}`
    leaf. Handled patterns (every projection of the dense and moe families,
    MLA's `bsd,dr->bsr`, `bsr,rhk->bshk` and `bshv,hvd->bsd` among them,
    as the JAX `_try_pallas`): x = <x-out><contract>, w = <contract><w-out>,
    out = <x-out><w-out>; and the same with one batch letter leading all
    three operands (the MoE experts, e.g. "egcd,edf->egcf"), which goes to
    the batched kernel."""
    if not is_quantized(w):
        if not x.is_cuda:
            return torch.einsum(eq, x, w)
        b, m, k, n, shape = _plan_2d(eq, x, w.shape)
        if b:                               # MoE experts: one batched product
            return torch.einsum(eq, x, w)
        w2 = w.reshape(k, n)
        return fixed_row_blocks(x.reshape(m, k), lambda r: r @ w2
                                ).reshape(shape)
    q, s = w[_QKEY], w["s"]
    b, m, k, n, shape = _plan_2d(eq, x, q.shape)
    # the keepdims scale has 1s on the contraction dims and the weight's
    # output dims in order, so a flat view is already in output-dim order
    if b:
        e = x.shape[0]
        y = int8_matmul_batched(x.reshape(e, m, k).contiguous(),
                                q.reshape(e, k, n),
                                s.reshape(e, n).float().contiguous())
    else:
        x2 = x.reshape(m, k)
        if x.is_cuda and x.dtype == torch.bfloat16 and m <= GEMV_MAX_M \
                and not _DECODE.get():
            # a short prefill: the tensor-core path a chunk's rows take
            x2 = torch.cat([x2, x2.new_zeros(ROW_BLOCK - m, k)])
        y = int8_matmul(x2.contiguous(), q.reshape(k, n),
                        s.reshape(n).float().contiguous())[:m]
    return y.reshape(shape)


def quantize_kv_rows(kv: torch.Tensor):
    """(..., D) K/V rows → (int8 rows, f16 per-row scale (...,)).

    Per-token-per-head symmetric int8 over the head dim. The scale is rounded
    to f16 BEFORE the divide, so `q * s` reconstructs within s/2 whichever
    layout stored the bytes; rounding is half-to-even, as `jnp.round`."""
    kvf = kv.float()
    absmax = torch.amax(kvf.abs(), dim=-1)
    s = torch.clamp(absmax / 127.0, min=1e-6).to(SCALE_DTYPE)
    q = torch.clamp(torch.round(kvf / s.float()[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv_rows(q: torch.Tensor, s: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    return (q.float() * s.float()[..., None]).to(dtype)
