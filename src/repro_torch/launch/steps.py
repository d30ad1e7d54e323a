"""The train step (port of `repro/launch/steps.py::make_train_step`) and
its compiled form.

The JAX module also builds shardings, jitted serve steps and the dry-run
cells; on one card none of that carries over, so only the train step, its
state, the train shape's options and the counterpart of `jax.jit(step,
donate_argnums=(0,))` are here. `abstract_train_state` becomes
`init_train_state`, which materialises the state from the port's init.

`make_train_step` is a plain function, as the reference's is before `jit`.
`CapturedTrainStep` compiles it the way the reference's train loop does:
one program a batch signature (each key's shape and dtype, as a `jax.jit`
cache is keyed), the state written in place. On the card that program is a
CUDA graph (`serve/graphs.StepFamily`, as the serving engines' steps).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.registry import ModelApi
from repro_torch.models.transformer import ExecOptions
from repro_torch.serve.graphs import StepFamily
from repro_torch.train import optimizer as opt_mod
from repro_torch.tree import tree_leaves, tree_map


def train_options(seq_len: int) -> Tuple[ExecOptions, Dict]:
    """The train shape's options: (ExecOptions for `build_model`, the
    `ce_chunk` / `remat` keywords of `make_train_step`).

    The train branch of the JAX `exec_options_for` with the overrides its
    train loop passes (`repro/launch/train.py`): the reference attention
    (the dense CUDA kernel has no backward), CE chunks of min(128, S),
    remat 'full' and MoE groups of min(64, S) tokens, which set the
    experts' capacity and so the routing. The chunked-attention fields and
    `act_seq_shard` have no meaning on one card with the reference
    attention."""
    return (ExecOptions(attn_impl="reference", moe_group=min(64, seq_len)),
            {"ce_chunk": min(128, seq_len), "remat": "full"})


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
    device, and the family's float inputs (`registry.train_inputs`:
    'patch_embeds' (B, P, d) for vlm, 'frames' (B, S, d) for encdec).
    n_micro > 1 accumulates gradients over microbatches in an f32 buffer;
    every key of the batch is split along B. The state is updated IN PLACE
    (params, m, v and the step counter `opt["step"]`) and returned, and
    nothing in the step reads a value back to the host, so
    `CapturedTrainStep` can capture it. `ce_chunk` and `remat` default to
    the JAX train shape's `exec_options_for` ('full' remat, 512-row CE
    chunks; `train_options` gives the train loop's)."""
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


# the torch dtype of each numpy dtype a batch may hold
_TORCH_OF_NUMPY = {np.dtype(np.bool_): torch.bool,
                   np.dtype(np.int32): torch.int32,
                   np.dtype(np.int64): torch.int64,
                   np.dtype(np.float32): torch.float32}


def _signature(batch) -> Tuple:
    """((key, shape, torch dtype), ...) in key order: what a `jax.jit`
    cache keys a batch by."""
    sig = []
    for k in sorted(batch):
        v = batch[k]
        if isinstance(v, torch.Tensor):
            dtype = v.dtype
        else:
            v = np.asarray(v)
            if v.dtype not in _TORCH_OF_NUMPY:
                raise TypeError(f"batch[{k!r}] has dtype {v.dtype}: give "
                                "it as a tensor")
            dtype = _TORCH_OF_NUMPY[v.dtype]
        sig.append((k, tuple(v.shape), dtype))
    return tuple(sig)


class CapturedTrainStep:
    """`step_fn` (a `make_train_step`) built once a batch signature and run
    at every step: the port's `jax.jit(step_fn, donate_argnums=(0,))`.

    `captured(state, batch)` → (state, metrics), as the jitted step is
    called. `state` is the train state the step was built on (params, m,
    v and the step counter, all written in place): a state whose tensors
    are not the ones a build read raises "rebound" before the step runs,
    as a donated buffer may not be read again. `batch` maps each key to a
    numpy array (bool, int32, int64, f32: staged through one pinned buffer
    and one copy) or a tensor (any dtype, copied on the device: the
    family inputs of `registry.train_inputs`).

    The step runs on the state's device. Each new signature is one build
    (`builds`; `sanitizer.note_compile` under no label, as the reference
    jits its train step unlabelled). Its first call runs the step for
    real and is the step; on a CUDA device
    (and not `eager`) the step is then captured into a CUDA graph, which
    executes nothing; `torch.cuda.graph` empties the allocator's cache
    first, so the capture's pool does not sit beside the first call's
    freed activations and gradients. Every later call copies the batch into the static
    buffers and replays the graph (`replays`); its kernel launches count on
    the wrappers' counters as the capture recorded them. On the CPU, and
    with `eager=True`, every call runs `step_fn` per op on the same static
    buffers. A failed capture raises; nothing falls back to per-op runs.

    The metrics (loss, grad_norm, lr) of a replay live in the graph's
    memory pool, and the next replay overwrites them: read them before the
    next call (the train loop reads the loss every step)."""

    def __init__(self, step_fn: Callable, state, *, eager: bool = False):
        self.step_fn, self.state = step_fn, state
        device = tree_leaves(state["params"])[0].device
        use_graph = device.type == "cuda" and not eager
        self.steps = StepFamily(
            self, CapturedTrainStep._run, state=CapturedTrainStep._state,
            stat=None, label=None, device=device, eager=eager,
            pool=torch.cuda.graph_pool_handle() if use_graph else None)

    def _run(self, inputs, key):
        return self.step_fn(self.state, inputs)

    def _state(self, key):
        opt = self.state["opt"]
        return (tree_leaves(self.state["params"]) + tree_leaves(opt["m"])
                + tree_leaves(opt["v"]) + [opt["step"]])

    @property
    def builds(self) -> int:
        """Batch signatures built (`jax.jit`'s `_cache_size()`)."""
        return self.steps.captures

    @property
    def replays(self) -> int:
        """CUDA graph replays (0 on the CPU and with `eager`)."""
        return self.steps.replays

    @property
    def captured(self) -> bool:
        """Every built signature is a CUDA graph."""
        return self.steps.captured

    def __call__(self, state, batch):
        self.state = state
        sig = _signature(batch)
        spec = {k: (shape, dtype) for k, shape, dtype in sig}
        return self.steps(sig, spec, **batch)
