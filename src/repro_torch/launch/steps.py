"""The train step (port of `repro/launch/steps.py::make_train_step`).

The JAX module also builds shardings, jitted serve steps and the dry-run
cells; on one card with eager PyTorch none of that carries over, so only the
train step and its state are here. `abstract_train_state` becomes
`init_train_state`, which materialises the state from the port's init.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.registry import ModelApi
from repro_torch.train import optimizer as opt_mod
from repro_torch.tree import tree_leaves, tree_map


def init_train_state(model: ModelApi, seed: int = 0):
    """{"params": model.init(seed), "opt": {"m", "v", "step"}} on the
    model's device."""
    params = model.init(seed)
    return {"params": params, "opt": opt_mod.init_opt_state(params)}


def loss_and_grads(model: ModelApi, params, batch, *, ce_chunk: int = 512,
                   remat: str = "full"):
    """(loss, grads tree in the params' dtypes) of `model.train_loss`.
    The params themselves are left untouched (gradients are taken through
    detached aliases)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = model.train_loss(leaves, batch, ce_chunk=ce_chunk, remat=remat)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(model: ModelApi, opt_cfg: opt_mod.OptimizerConfig,
                    grad_transform: Optional[Callable] = None,
                    n_micro: int = 1, *, ce_chunk: int = 512,
                    remat: str = "full"):
    """(state, batch) → (state, metrics {"loss", "grad_norm", "lr"}).

    `batch` holds (B, S) int tensors 'tokens' and 'labels' on the model's
    device. n_micro > 1 accumulates gradients over microbatches in an f32
    buffer. The state is updated IN PLACE (params, m, v; `opt["step"]` is
    replaced) and returned. `ce_chunk` and `remat` default to the JAX train
    shape's `exec_options_for` ('full' remat, 512-row CE chunks)."""
    kw = dict(ce_chunk=ce_chunk, remat=remat)

    def step(state, batch):
        params = state["params"]
        if n_micro == 1:
            loss, grads = loss_and_grads(model, params, batch, **kw)
            grads = tree_map(lambda g: g.float(), grads)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} is not divisible by n_micro "
                                 f"{n_micro}")
            mb_size = b // n_micro
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(n_micro):
                mb = {k: v[i * mb_size:(i + 1) * mb_size]
                      for k, v in batch.items()}
                mb_loss, g = loss_and_grads(model, params, mb, **kw)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi.float() / n_micro)
                loss = loss + mb_loss / n_micro
        if grad_transform is not None:  # e.g. compression-aware DP sync
            grads = grad_transform(grads)
        grads, gnorm = opt_mod.clip_by_global_norm(grads, opt_cfg.clip_norm)
        _, opt, lr = opt_mod.adamw_update(params, grads, state["opt"],
                                          opt_cfg)
        state["opt"] = opt
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step
