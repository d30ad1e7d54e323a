"""PyTorch + CUDA port of the `repro` serving stack for one NVIDIA H100.

Mirrors the JAX package's module names (`configs`, `models`, `kernels`,
`serve`, `launch`) so every function has a findable counterpart. The JAX
package stays the reference; this package imports `torch` and numpy only.

Entry points take `device=None`, which means CUDA: with no GPU they raise
unless the caller passes `device="cpu"` explicitly (the CPU tests do). Nothing
falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` → the CUDA device (raises without one); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch paths")
        return torch.device("cuda")
    return torch.device(device)
