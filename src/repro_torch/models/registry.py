"""Model registry (port of `repro/models/registry.py`), dense family only.

`build_model(cfg, device=None)` returns a `ModelApi` whose members are plain
functions of (params, batch[, cache]). `device=None` means CUDA and raises
without a GPU; the CPU tests pass `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.common import init_params

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    device: torch.device
    schema: Any
    train_loss: Callable     # (params, batch, *, ce_chunk, remat) -> (loss, metrics)
    prefill: Callable        # (params, batch) -> (logits, cache)
    decode: Callable         # (params, batch, cache) -> (logits, cache)
    cache_shape: Callable    # (batch, max_len, dtype, ...) -> {name: (shape, dtype)}
    prefill_cache: Optional[Callable] = None
    prefill_chunk: Optional[Callable] = None

    def init(self, seed: int = 0, dtype=None):
        """Random weights from a seeded `torch.Generator` on the model's
        device (the JAX package's distributions, not its random stream)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.schema, gen, dtype or _DTYPES[self.cfg.dtype],
                           self.device)


def build_model(cfg: ArchConfig, device=None) -> ModelApi:
    if cfg.family != "dense" or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"family {cfg.family!r} (attn_kind {cfg.attn_kind!r}) comes with "
            "ROADMAP A10 (remaining model families)")
    device = resolve_device(device)
    return ModelApi(
        cfg=cfg, device=device, schema=transformer.schema(cfg),
        train_loss=functools.partial(transformer.train_loss, cfg=cfg),
        prefill=functools.partial(transformer.prefill, cfg=cfg),
        decode=functools.partial(transformer.decode_step, cfg=cfg),
        cache_shape=functools.partial(transformer.cache_shape, cfg),
        prefill_cache=functools.partial(transformer.prefill_cache, cfg=cfg),
        prefill_chunk=functools.partial(transformer.prefill_chunk, cfg=cfg),
    )
