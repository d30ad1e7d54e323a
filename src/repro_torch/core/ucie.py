"""I2 — AI-aware UCIe die-to-die link model (port of `repro/core/ucie.py`).

UCIe moves data in 64-byte FLITs with per-FLIT protocol overhead (CRC, header,
retry). The paper's extensions:

  * *streaming FLITs*  — header cost amortized over a burst instead of per FLIT,
  * *compression-aware transfers* — payload compressed before the link,
  * *predictive prefetching* — transfers overlap compute (the scheduler in
    soc.py and the `prefetch_overlap` flag of the closed-form model).

`transfer()` is the closed-form per-message cost; `LinkState`/`link_tick` give
the queued, bandwidth-limited behaviour for the time-stepped simulator. Every
function broadcasts over leading axes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import resolve_device
from repro_torch.rounding import const

FLIT_BYTES = 64.0           # UCIe flit payload granularity
HEADER_BYTES = 8.0          # per-flit protocol bytes (CRC+hdr, raw mode)
STREAM_BURST_FLITS = 64.0   # streaming mode amortizes one header per burst


@dataclasses.dataclass(frozen=True)
class UCIeConfig:
    bandwidth_gbps: float = 24.0      # per-direction link bandwidth
    latency_us: float = 0.8           # one-way link latency
    streaming: bool = True            # streaming-FLIT extension
    compression_ratio: float = 0.75   # effective payload ratio (1.0 = off)
    compression_us_per_kb: float = 0.002  # (de)compression engine cost
    pj_per_bit: float = 0.5           # link energy

    def as_vector(self, device=None) -> torch.Tensor:
        """(..., 6) f32. Fields may be tensors of one batch shape (the
        simulator's per-design link parameters); the result is on their
        device, else on `device`."""
        fields = (self.bandwidth_gbps, self.latency_us, self.streaming,
                  self.compression_ratio, self.compression_us_per_kb,
                  self.pj_per_bit)
        dev = next((f.device for f in fields if isinstance(f, torch.Tensor)),
                   None)
        dev = resolve_device(device) if dev is None else dev
        cols = [torch.as_tensor(f, device=dev).to(torch.float32)
                for f in fields]
        return torch.stack(torch.broadcast_tensors(*cols), dim=-1)


def flit_wire_bytes(streaming: torch.Tensor) -> torch.Tensor:
    """Wire bytes per FLIT: its payload plus its share of headers."""
    streaming = torch.as_tensor(streaming, dtype=torch.float32)
    return FLIT_BYTES + torch.where(
        streaming > 0.5, HEADER_BYTES / STREAM_BURST_FLITS, HEADER_BYTES)


def protocol_efficiency(streaming: torch.Tensor) -> torch.Tensor:
    """Payload bytes / wire bytes."""
    wire = flit_wire_bytes(streaming)
    # a tensor numerator: `scalar / tensor` is a reciprocal times the scalar
    flit = torch.tensor(FLIT_BYTES, dtype=torch.float32, device=wire.device)
    return flit / wire


def to_wire_bytes(payload: torch.Tensor, streaming) -> torch.Tensor:
    """`payload / protocol_efficiency(streaming)` as the reference's compiled
    code divides it: `a / (b / c)` is `a * c / b`, and / 64 is exact."""
    return payload * flit_wire_bytes(streaming) * (1.0 / FLIT_BYTES)


def transfer(
    payload_bytes: torch.Tensor,
    cfg: UCIeConfig | torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form cost of one message.

    Returns (time_us, energy_mj, wire_bytes). Differentiable; `cfg` may be a
    UCIeConfig or its `as_vector()` encoding (..., 6) for batched sweeps.
    """
    vec = (cfg.as_vector(payload_bytes.device)
           if isinstance(cfg, UCIeConfig) else cfg)
    bw_gbps, lat_us, streaming, cr, comp_us_kb, pj_bit = (
        vec[..., i] for i in range(6))

    compressed = payload_bytes * cr
    # a division by 64 is exact, so this is the quotient on every device
    n_flits = torch.ceil(compressed * (1.0 / FLIT_BYTES))
    wire_bytes = to_wire_bytes(n_flits * FLIT_BYTES, streaming)
    t_wire_us = wire_bytes * 8.0 / (bw_gbps * 1e3)  # Gbps = bits/ns -> us
    t_comp_us = torch.where(
        cr < 1.0, (payload_bytes * (1.0 / 1024.0)) * comp_us_kb, 0.0)
    time_us = lat_us + t_wire_us + t_comp_us
    energy_mj = wire_bytes * 8.0 * pj_bit * 1e-9  # pJ/bit -> mJ
    return time_us, energy_mj, wire_bytes


def migration_ticks(
    payload_bytes: float,
    cfg: UCIeConfig | torch.Tensor,
    *,
    tick_us: float,
    device=None,
) -> int:
    """Engine ticks one KV page-migration transfer occupies the link: the
    `transfer()` time in whole ticks, at least one."""
    device = cfg.device if isinstance(cfg, torch.Tensor) \
        else resolve_device(device)
    t_us, _, _ = transfer(
        torch.tensor(payload_bytes, dtype=torch.float32, device=device), cfg)
    return max(1, int(-(-float(t_us) // float(tick_us))))


@dataclasses.dataclass
class LinkState:
    """Bandwidth-limited FIFO queue for the time-stepped simulator."""

    queued_bytes: torch.Tensor    # (...,) f32 wire bytes waiting
    wire_bytes_total: torch.Tensor
    energy_mj: torch.Tensor


def init_link(shape=(), device=None) -> LinkState:
    z = torch.zeros(shape, dtype=torch.float32, device=resolve_device(device))
    return LinkState(queued_bytes=z, wire_bytes_total=z, energy_mj=z)


def link_capacity(bandwidth_gbps, tick_ms: float):
    """Wire bytes the link drains in one tick: for a tensor bandwidth with the
    constants folded into one f32 factor, as the reference's compiled tick
    has them; for a Python float in Python."""
    if isinstance(bandwidth_gbps, torch.Tensor):
        return bandwidth_gbps * const(1e9, 0.125, tick_ms / 1e3)
    return bandwidth_gbps * 1e9 / 8.0 * (tick_ms / 1e3)


def drain(state: LinkState, wire: torch.Tensor, energy_mj: torch.Tensor,
          capacity: torch.Tensor
          ) -> Tuple[LinkState, Tuple[torch.Tensor, torch.Tensor]]:
    """`link_tick` after `transfer`: enqueue `wire` bytes, drain `capacity`.
    The simulator calls it with a design's per-tick transfer computed once."""
    queued = state.queued_bytes + wire
    capacity = torch.as_tensor(capacity, dtype=torch.float32,
                               device=queued.device)
    drained = torch.minimum(queued, capacity)
    occupancy = drained / torch.clamp(capacity, min=1e-9)
    return (
        LinkState(
            queued_bytes=queued - drained,
            wire_bytes_total=state.wire_bytes_total + wire,
            energy_mj=state.energy_mj + energy_mj,
        ),
        (drained, occupancy),
    )


def link_tick(
    state: LinkState,
    new_payload_bytes: torch.Tensor,
    cfg: UCIeConfig,
    tick_ms: float,
) -> Tuple[LinkState, Tuple[torch.Tensor, torch.Tensor]]:
    """Enqueue `new_payload_bytes`, drain at link bandwidth for one tick.

    Returns (state, (drained_bytes, occupancy)) where occupancy in [0,1] is the
    fraction of the tick the link was busy (drives comm power in soc.py).
    """
    _, energy_mj, wire = transfer(new_payload_bytes, cfg)
    return drain(state, wire, energy_mj,
                 link_capacity(cfg.bandwidth_gbps, tick_ms))
