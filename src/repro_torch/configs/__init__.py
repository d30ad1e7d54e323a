"""Architecture registry: the 10 assigned architectures × their shape sets."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (
    SHAPES,
    SHAPE_ORDER,
    ArchConfig,
    ShapeConfig,
    cell_is_runnable,
)

_MODULES = {
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
}

ARCH_ORDER = tuple(_MODULES)

# Post-assignment archs: resolvable via get_config but outside ARCH_ORDER —
# the assignment's 10×4 dry-run/roofline grid stays fixed.
_EXTRA_MODULES = {
    "deepseek-v2-lite": "repro_torch.configs.deepseek_v2_lite",  # MLA latent-KV
}
_MODULES = {**_MODULES, **_EXTRA_MODULES}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in ARCH_ORDER}


def all_cells():
    """Every (arch, shape) cell with its runnability verdict — 40 total."""
    out = []
    for a in ARCH_ORDER:
        cfg = get_config(a)
        for s in SHAPE_ORDER:
            ok, why = cell_is_runnable(cfg, SHAPES[s])
            out.append((a, s, ok, why))
    return out


__all__ = [
    "ARCH_ORDER",
    "ArchConfig",
    "SHAPES",
    "SHAPE_ORDER",
    "ShapeConfig",
    "all_cells",
    "all_configs",
    "cell_is_runnable",
    "get_config",
]
