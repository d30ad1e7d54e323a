"""Weights bridge: a numpy params tree (the JAX pytree after
`jax.tree.map(np.asarray, params)`) → torch tensors with the same nesting and
leaf names, stacked layer axis 0 kept.

Quantized leaves `{"int8_q", "s"}` are plain dicts and bridge like any other,
and so does a train state `{"params", "opt": {"m", "v", "step"}}` (its 0-d
int32 step stays 0-d).
bf16 leaves arrive as `ml_dtypes.bfloat16` arrays, which `torch.from_numpy`
rejects; they cross as a `uint16` view and come back as `torch.bfloat16`, bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim:       # np.ascontiguousarray would turn a 0-d step into (1,)
        a = np.ascontiguousarray(a)
    if _is_bf16(a):
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays → nested dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of `tensor_from_numpy` (bf16 returns as `ml_dtypes.bfloat16`)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)
