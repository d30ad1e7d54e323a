"""The serving mesh (port of `repro/launch/mesh.py::make_serve_mesh`).

The reference shards slots over a 1-D device mesh, one shard a device, and
runs its global programs under `shard_map`. On one card the port keeps
the same layout on one device: the shards' page ranges are contiguous
slices of one global pool and the global decode step is one batch, as
`shard_map` computes it. `ServeMesh` carries what the sharded engine reads
of a mesh: its `shape` ({axis: n}) and the device that holds every shard.
Placing shards on separate cards waits for a machine with more than one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """`shape`: {axis name: size}, as `jax.sharding.Mesh.shape`; `device`:
    the torch device every shard lives on."""
    shape: Dict[str, int]
    device: torch.device


def make_serve_mesh(n_shards: int = 1, axis: str = "data",
                    device=None) -> ServeMesh:
    """1-D slot-sharding mesh of `n_shards` shards along `axis`, all on
    `device` (None: the CUDA device, as every entry point of the port)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return ServeMesh(shape={axis: int(n_shards)},
                     device=resolve_device(device))
