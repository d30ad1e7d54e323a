"""Compression-aware gradient synchronization (port of
`repro/train/compression.py`).

Gradients are block-quantized to int8 (+ an f32 scale per 256-value block,
≈ 4× smaller payload) with an error-feedback residual, so the quantization
error can be re-injected next step. `compress_decompress` is the in-graph
quantize → dequantize the train step applies as its `grad_transform`; on
CUDA tensors it runs the hand-written `quantize_blocks`/`dequantize_blocks`
kernels once per leaf each.

`compressed_ring_allreduce` (a shard_map ring whose hops carry int8) has no
counterpart on one card and waits for ROADMAP A14 (training across
cards; it was filed under A12, sharded serving).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_map


def init_error_state(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize_leaf(g: torch.Tensor, block: int = 256):
    return kops.quantize_blocks(g.float(), block=block)


def dequantize_leaf(q, s, n, shape, block: int = 256):
    return kops.dequantize_blocks(q, s, n, shape, dtype=torch.float32)


def compress_decompress(grads, error_state=None, *, block: int = 256):
    """Quantize-dequantize each gradient leaf with error feedback.

    Returns (grads_hat, new_error_state), trees shaped like `grads`. Without
    an error state the residual starts from zeros, as in the reference."""
    def one(g, e):
        gf = g.float() + e        # + 0.0 without a state: -0.0 → +0.0 as JAX
        q, s, n = quantize_leaf(gf, block)
        ghat = dequantize_leaf(q, s, n, gf.shape, block)
        return ghat.to(g.dtype), gf - ghat

    if error_state is None:
        pairs = tree_map(lambda g: one(g, 0.0), grads)
    else:
        pairs = tree_map(one, grads, error_state)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def compressed_ring_allreduce(x, axis_name, block: int = 256):
    raise NotImplementedError(
        "compressed_ring_allreduce is a multi-device shard_map collective; "
        "it comes with ROADMAP A14 (torch.distributed process groups; "
        "filed under A12 before sharded serving was ported)")


def payload_ratio(shape, block: int = 256) -> float:
    """Compressed/uncompressed byte ratio for one f32 tensor."""
    n = math.prod(shape)
    blocks = -(-n // block)
    return (blocks * block * 1 + blocks * 4) / (n * 4)
