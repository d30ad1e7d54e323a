"""AdamW + schedules + global-norm clipping (port of `repro/train/optimizer.py`).

The functions are ported as written, not replaced by `torch.optim.AdamW`,
whose decay and rounding order differ:
  * weight decay applies to every leaf, norms and embedding included;
  * the math runs in f32 and the result is cast back to the param dtype:
    there are no f32 master weights (the reference's behaviour);
  * the schedule and the bias corrections are f32 tensors, as in JAX, not
    Python floats in f64.
Trees are nested dicts of tensors, visited in sorted-key order
(`repro_torch.tree`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to end_lr_frac·peak (f32 tensor)."""
    step = step.float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    # the cosine of the f32 argument, evaluated in f64 and rounded to f32:
    # PyTorch's f32 cos is an ulp off XLA's at some steps, the rounded f64
    # value almost never
    cos_t = torch.cos((math.pi * t).double()).float()
    cos = cfg.end_lr_frac + (1 - cfg.end_lr_frac) * 0.5 * (1 + cos_t)
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params) -> Dict[str, Any]:
    """f32 zeros for m and v beside every param leaf; step 0 (int32)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    total = 0
    for g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads · min(1, max_norm / norm) in f32, norm)."""
    norm = global_norm(grads)
    # a tensor numerator: `float / tensor` would multiply by the reciprocal
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: OptimizerConfig):
    """One AdamW step; grads may be any float dtype, the math is f32.

    Updates IN PLACE, under `torch.no_grad()`: every param leaf, `m`, `v`
    and the step counter `opt_state["step"]` (+ 1) are overwritten, so a
    captured step (`launch/steps.CapturedTrainStep`) reads and writes the
    same tensors on every replay. Returns (params, opt_state, lr) — the
    same dicts — as the JAX function returns its new trees."""
    step = opt_state["step"].add_(1)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        gf = g.float()
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * torch.square(gf))
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, opt_state, lr
