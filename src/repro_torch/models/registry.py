"""Model registry (port of `repro/models/registry.py`): the dense, moe and
vlm families on the decoder-only transformer (attention GQA, or MLA as in
deepseek-v2-lite), the encdec family on `models/encdec.py`, the ssm family
on `models/ssm.py` and the hybrid family on `models/rglru.py`.

`build_model(cfg, opts=None, device=None)` returns a `ModelApi` whose members
are plain functions of (params, batch[, cache]). `opts` (`ExecOptions`,
default: JAX's defaults) picks the full-sequence attention of the train and
prefill modes. `device=None` means CUDA and raises without a GPU; the CPU
tests pass `device="cpu"`. The recurrent families (ssm, hybrid) have no
cache-only or chunked prefill: their engine admits on the exact-length
`prefill` and takes the first token from its logits. `train_inputs` draws
a train batch of the JAX `make_inputs`' train shape (with 'patch_embeds'
for vlm, 'frames' for encdec) from a seeded `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, rglru, ssm, transformer
from repro_torch.models.common import init_params, init_params_by_layer
from repro_torch.models.transformer import ExecOptions

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# families whose serving state is recurrent (no KV rows to page or replay)
_RECURRENT = ("ssm", "hybrid")


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
    # encdec only: (params, batch) -> {'ck', 'cv'}, the encoder and the
    # cross K/V, computed once a request for the chunked prefill path
    prefill_cross: Optional[Callable] = None

    def init(self, seed: int = 0, dtype=None, by_layer: bool = False,
             transform=None):
        """Random weights from a seeded `torch.Generator` on the model's
        device (the JAX package's distributions, not its random stream).
        `by_layer` draws each layer-stacked leaf one layer slice at a time
        (`init_params_by_layer`: a stream of its own, f32 temporaries of
        one layer), mapping each slice through `transform(path, x)`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dtype = dtype or _DTYPES[self.cfg.dtype]
        if by_layer and self.cfg.family in _RECURRENT:
            raise ValueError(
                f"by-layer draws are for the attention families; draw the "
                f"{self.cfg.family!r} family whole (the hybrid's stacks "
                "have three lengths; mamba2-780m and recurrentgemma-2b fit "
                "a whole draw)")
        if by_layer:
            return init_params_by_layer(self.schema, gen, dtype, self.device,
                                        transform)
        if transform is not None:
            raise ValueError("transform applies to the by-layer draw only")
        return init_params(self.schema, gen, dtype, self.device)

    def init_int8(self, seed: int = 0, transform=None):
        """The by-layer draw of `init(seed, by_layer=True,
        transform=transform)` with the int8 leaves `quantize_params` makes,
        quantized slice by slice as they are drawn: bit for bit that tree
        quantized, without ever holding it. An engine with
        `wdtype="int8"` takes it as it is."""
        from repro_torch.models.quantized import init_int8_by_layer
        if self.cfg.family in _RECURRENT:
            raise ValueError(f"int8 weights apply to attention families, "
                             f"not {self.cfg.family!r}")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_int8_by_layer(self.schema, gen, self.cfg,
                                  _DTYPES[self.cfg.dtype], self.device,
                                  transform)


def build_model(cfg: ArchConfig, opts: Optional[ExecOptions] = None,
                device=None) -> ModelApi:
    opts = opts or ExecOptions()
    fam = cfg.family
    if fam not in ("dense", "moe", "vlm", "encdec", "ssm", "hybrid"):
        raise ValueError(f"unknown family {fam!r}")
    if cfg.attn_kind not in ("gqa", "mla") or (
            cfg.attn_kind == "mla" and fam not in ("dense", "moe", "vlm")):
        raise ValueError(f"attn_kind {cfg.attn_kind!r} with family {fam!r} "
                         f"({cfg.name})")
    device = resolve_device(device)
    if fam in ("dense", "moe", "vlm"):
        return ModelApi(
            cfg=cfg, device=device, schema=transformer.schema(cfg),
            train_loss=functools.partial(transformer.train_loss, cfg=cfg,
                                         opts=opts),
            prefill=functools.partial(transformer.prefill, cfg=cfg,
                                      opts=opts),
            decode=functools.partial(transformer.decode_step, cfg=cfg),
            cache_shape=functools.partial(transformer.cache_shape, cfg),
            prefill_cache=functools.partial(transformer.prefill_cache,
                                            cfg=cfg, opts=opts),
            prefill_chunk=functools.partial(transformer.prefill_chunk,
                                            cfg=cfg),
        )
    if fam in _RECURRENT:
        mod = ssm if fam == "ssm" else rglru
        return ModelApi(
            cfg=cfg, device=device, schema=mod.schema(cfg),
            train_loss=functools.partial(mod.train_loss, cfg=cfg, opts=opts),
            prefill=functools.partial(mod.prefill, cfg=cfg, opts=opts),
            decode=functools.partial(mod.decode_step, cfg=cfg, opts=opts),
            cache_shape=functools.partial(mod.cache_shape, cfg),
        )
    return ModelApi(
        cfg=cfg, device=device, schema=encdec.schema(cfg),
        train_loss=functools.partial(encdec.train_loss, cfg=cfg, opts=opts),
        prefill=functools.partial(encdec.prefill, cfg=cfg, opts=opts),
        decode=functools.partial(encdec.decode_step, cfg=cfg, opts=opts),
        cache_shape=functools.partial(encdec.cache_shape, cfg),
        prefill_cache=functools.partial(encdec.prefill_cache, cfg=cfg,
                                        opts=opts),
        prefill_chunk=functools.partial(encdec.prefill_chunk, cfg=cfg,
                                        opts=opts),
        prefill_cross=functools.partial(encdec.prefill_cross, cfg=cfg,
                                        opts=opts),
    )


def train_input_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """{name: shape} of one train batch (the train branch of the JAX
    `input_specs`): 'tokens', 'labels' (B, S) int32, and 'patch_embeds'
    (B, n_image_tokens, d) for vlm or 'frames' (B, S, d) for encdec in the
    float dtype the caller picks."""
    shapes = {"tokens": (batch, seq_len), "labels": (batch, seq_len)}
    if cfg.family == "vlm":
        shapes["patch_embeds"] = (batch, cfg.n_image_tokens, cfg.d_model)
    if cfg.family == "encdec":
        shapes["frames"] = (batch, seq_len, cfg.d_model)
    return shapes


def train_inputs(cfg: ArchConfig, batch: int, seq_len: int, *,
                 seed: int = 0, device=None, dtype=torch.bfloat16) -> dict:
    """Random inputs of `train_input_shapes` (the JAX `make_inputs` for the
    train shape), drawn from a `torch.Generator` seeded with `seed` on
    `device` (None: CUDA): ints uniform in [0, vocab), floats standard
    normal cast to `dtype`. The bits are not `jax.random`'s."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in train_input_shapes(cfg, batch, seq_len).items():
        if name in ("tokens", "labels"):
            out[name] = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                      device=device, dtype=torch.int32)
        else:
            out[name] = torch.randn(shape, generator=gen, device=device,
                                    dtype=torch.float32).to(dtype)
    return out
