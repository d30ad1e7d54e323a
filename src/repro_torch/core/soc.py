"""Time-stepped chiplet SoC simulator — composes I1 (DVFS), I2 (UCIe),
I3 (security), I4 (thermal/migration) over the paper's floorplan (port of
`repro/core/soc.py`).

The paper's SoC (Fig 1): on a 30x30 mm interposer,
  * 5x5 mm  7 nm RISC-V CPU chiplet (custom vector extensions)
  * 2x 6x4 mm 5 nm NPU chiplets, 15 TOPS INT8 each
  * 16 GB HBM3 stack (819 GB/s)
  * 7x3 mm I/O + power-management chiplet
  * 3x2 mm security controller

Fixed ticks (default 0.1 ms): requests arrive, their activations cross the
UCIe link (compressed/streamed per scenario, AEAD-sealed per the security
config), the CPU dispatches work across the two NPUs, the DVFS controller
retunes per-chiplet P-states, and the RC thermal network integrates —
migrating load off a hot NPU when the predictor fires.

The reference scans one design point and vmaps the scan over designs and
rates. Here one core runs the whole batch: every tensor carries the leading
(designs, rates) axes, chiplets last, and a Python loop over ticks issues each
tick's ops once for the whole batch. `simulate` is the 1 × 1 case. The I1–I4
flags stay per-design 0/1 values selected branchlessly.

The tick's f32 arithmetic rounds as the reference's compiled scan does: its
products fused into the adds that consume them, divisions by constants taken
as reciprocal products, chains of constant factors folded, `a / b / c` as
`a / (b * c)` (`rounding`), sums over chiplets in index order. Counters and knees then equal the reference's exactly, and the
card's run equals the CPU's.

Compile once, as the reference jits its scan: on the card the tick loop
replays a CUDA graph of `TICK_BLOCK` ticks. A call first runs the ticks
that do not fill a block per op (at least one, which makes every constant
the tick reads), then captures one block, which reads the state, the
running peak temperature and the f64 power sum from static tensors and
writes them back in place, and replays it for the rest. The block launches
the same kernels in the same order as the per-op loop, so the results are
bit-equal to an `eager=True` run (and, as that run is, to the CPU's).
`TICK_BLOCK` is 50: a capture costs the host about as much as running its
ticks per op, so a 2,000-tick call pays about 50 ticks of capture and at
most 50 per-op ticks, about 5 % of its per-op host time, while a block of
~12,500 kernels (249 a tick) stays quick to instantiate. The CPU and
`eager=True` run every tick per op.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import dvfs as dvfs_mod
from repro_torch.core import thermal as thermal_mod
from repro_torch.core import ucie as ucie_mod
from repro_torch.core._batch import constant, sum_last
from repro_torch.core.perf_model import ALPHA
from repro_torch.core.scenarios import Scenario
from repro_torch.core.security import (
    SecurityConfig, aead_overhead, attestation_latency_us)
from repro_torch.core.workloads import Workload
from repro_torch.rounding import const, fma, recip

# ticks in one captured block of the tick loop (see the module docstring)
TICK_BLOCK = 50


@dataclasses.dataclass(frozen=True)
class ChipletSpec:
    name: str
    kind: str                  # cpu | npu | mem | io | sec
    area_mm2: float
    peak_dyn_mw: float
    static_mw: float
    r_k_per_w: float
    c_j_per_k: float


def paper_floorplan(scenario: Scenario) -> Tuple[ChipletSpec, ...]:
    """The paper's five-chiplet SoC, with the scenario's power envelope split
    across dies (NPUs dominate; ratios follow the floorplan areas and node
    maturity). Static share follows Table I's static_power_ratio."""
    p0 = scenario.base_power_mw
    st = scenario.static_power_ratio
    # dynamic-share split: cpu .20, npu .30 each, mem .12, io .06, sec .02
    shares = {"cpu": 0.20, "npu0": 0.30, "npu1": 0.30, "hbm": 0.12, "io": 0.06,
              "sec": 0.02}
    dyn = p0 * (1.0 - st)
    stat = p0 * st
    mk = lambda n, k, a, r, c: ChipletSpec(  # noqa: E731
        n, k, a, dyn * shares[n], stat * shares[n], r, c
    )
    return (
        mk("cpu", "cpu", 25.0, 9.0, 0.9),
        mk("npu0", "npu", 24.0, 8.0, 0.8),
        mk("npu1", "npu", 24.0, 8.0, 0.8),
        mk("hbm", "mem", 121.0, 6.0, 3.0),
        mk("io", "io", 21.0, 12.0, 0.7),
        mk("sec", "sec", 6.0, 20.0, 0.3),
    )


@dataclasses.dataclass(frozen=True)
class SoCConfig:
    scenario: Scenario
    chiplets: Tuple[ChipletSpec, ...]
    ucie: ucie_mod.UCIeConfig
    dvfs: dvfs_mod.DVFSConfig
    thermal: thermal_mod.ThermalConfig
    security: SecurityConfig
    tick_ms: float = 0.1


def build_soc(scenario: Scenario, *, security: bool = True) -> SoCConfig:
    chiplets = paper_floorplan(scenario)
    bw = scenario.link_bandwidth_gbps
    mono = scenario.is_monolithic
    return SoCConfig(
        scenario=scenario,
        chiplets=chiplets,
        ucie=ucie_mod.UCIeConfig(
            bandwidth_gbps=1e6 if mono else bw,
            latency_us=scenario.link_latency_us,
            streaming=scenario.prefetch_overlap,
            compression_ratio=scenario.compression_ratio,
        ),
        dvfs=dvfs_mod.DVFSConfig(
            power_budget_mw=scenario.base_power_mw,
            adaptive=scenario.dvfs_adaptive,
        ),
        thermal=thermal_mod.ThermalConfig(
            r_k_per_w=tuple(c.r_k_per_w for c in chiplets),
            c_j_per_k=tuple(c.c_j_per_k for c in chiplets),
            predictive=scenario.dvfs_adaptive,
        ),
        security=SecurityConfig(enabled=security and not mono),
        tick_ms=0.1,
    )


def hot_variant(soc):
    """The SoC `soc` with npu1 on a poor heat path (R 12 K/W, C 0.6 J/K) and
    the trip points just above ambient (migrate 45.01 °C, throttle 45.02,
    critical 45.1). On the paper's floorplan no grid of the paper's rates
    migrates or throttles (peak temperature stays under 46 °C against trips
    of 88/95 °C, and the two NPUs tie), so I4 runs only in this variant.
    Works on any config with this module's field names."""
    chiplets = tuple(
        dataclasses.replace(c, r_k_per_w=12.0, c_j_per_k=0.6)
        if c.name == "npu1" else c for c in soc.chiplets)
    thermal = dataclasses.replace(
        soc.thermal,
        r_k_per_w=tuple(c.r_k_per_w for c in chiplets),
        c_j_per_k=tuple(c.c_j_per_k for c in chiplets),
        t_migrate_c=45.01, t_throttle_c=45.02, t_critical_c=45.1)
    return dataclasses.replace(soc, chiplets=chiplets, thermal=thermal)


@dataclasses.dataclass
class SimState:
    dvfs: dvfs_mod.DVFSState
    thermal: thermal_mod.ThermalState
    link: ucie_mod.LinkState
    npu_queue_ms: torch.Tensor    # (..., n_chiplets) work queued per die
    staged_images: torch.Tensor   # (...,) images whose activations crossed the link
    completed: torch.Tensor       # (...,) f32 images finished
    busy_ms: torch.Tensor         # (...,) cumulative NPU busy time
    energy_mj: torch.Tensor       # (...,) total SoC energy
    queue_integral: torch.Tensor  # (...,) sum of queue depth (Little's-law latency)


# ---------------------------------------------------------------------------
# Batched parameter encoding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SoCParams:
    """The numeric leaves of SoC design points, any leading batch shape.

    Everything `simulate` reads from Python objects (ChipletSpec fields,
    scenario scalars, I1–I4 feature flags) lifted into tensors, so the
    time-stepped simulator is a function of (SoCParams, arrival rate) and one
    call sweeps a whole design space. Boolean mechanisms are 0/1 floats
    consumed branchlessly downstream.
    """

    peak_dyn_mw: torch.Tensor        # (..., n_chiplets)
    static_mw: torch.Tensor          # (..., n_chiplets)
    r_k_per_w: torch.Tensor          # (..., n_chiplets)
    c_j_per_k: torch.Tensor          # (..., n_chiplets)
    ucie_bandwidth_gbps: torch.Tensor
    ucie_latency_us: torch.Tensor
    ucie_streaming: torch.Tensor     # 0/1
    ucie_compression_ratio: torch.Tensor
    dvfs_budget_mw: torch.Tensor
    dvfs_adaptive: torch.Tensor      # 0/1
    thermal_predictive: torch.Tensor  # 0/1
    sec_enabled: torch.Tensor        # 0/1
    efficiency_factor: torch.Tensor
    protocol_overhead: torch.Tensor
    prefetch_overlap: torch.Tensor   # 0/1

    PER_CHIPLET = ("peak_dyn_mw", "static_mw", "r_k_per_w", "c_j_per_k")

    def map(self, fn) -> "SoCParams":
        return SoCParams(**{f.name: fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)})

    @staticmethod
    def stack(params: Sequence["SoCParams"]) -> "SoCParams":
        """Design points stacked on a new leading axis."""
        return SoCParams(**{
            f.name: torch.stack([getattr(p, f.name) for p in params])
            for f in dataclasses.fields(SoCParams)})


# The continuous lifted leaves in `SoCParams` order: the per-chiplet power,
# R and C vectors, then the link, budget and silicon scalars. A design sweep
# scales each by its own factor; the 0/1 mechanism flags stay.
CONTINUOUS = ("peak_dyn_mw", "static_mw", "r_k_per_w", "c_j_per_k",
              "ucie_bandwidth_gbps", "ucie_latency_us",
              "ucie_compression_ratio", "dvfs_budget_mw", "efficiency_factor",
              "protocol_overhead")


def scale_designs(p: SoCParams, factors: torch.Tensor) -> SoCParams:
    """N designs around the one design point `p`: `factors` (N, k) holds one
    column per scalar of the `CONTINUOUS` leaves in order (n_chiplets columns
    for a per-chiplet leaf), and each leaf is multiplied by its columns."""
    n = p.peak_dyn_mw.shape[-1]
    out, col = {}, 0
    for f in dataclasses.fields(p):
        x = getattr(p, f.name)
        if f.name not in CONTINUOUS:
            out[f.name] = x.expand(factors.shape[0], *x.shape).contiguous()
            continue
        width = n if f.name in SoCParams.PER_CHIPLET else 1
        scale = factors[:, col:col + width]
        out[f.name] = x * (scale if width > 1 else scale[:, 0])
        col += width
    assert col == factors.shape[1], (col, factors.shape)
    return SoCParams(**out)


def soc_params(soc: SoCConfig, device=None) -> SoCParams:
    """Lift a SoCConfig's Python-side reads into the tensor encoding."""
    device = resolve_device(device)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    sc = soc.scenario
    return SoCParams(
        peak_dyn_mw=f32([c.peak_dyn_mw for c in soc.chiplets]),
        static_mw=f32([c.static_mw for c in soc.chiplets]),
        r_k_per_w=f32([c.r_k_per_w for c in soc.chiplets]),
        c_j_per_k=f32([c.c_j_per_k for c in soc.chiplets]),
        ucie_bandwidth_gbps=f32(soc.ucie.bandwidth_gbps),
        ucie_latency_us=f32(soc.ucie.latency_us),
        ucie_streaming=f32(float(soc.ucie.streaming)),
        ucie_compression_ratio=f32(soc.ucie.compression_ratio),
        dvfs_budget_mw=f32(soc.dvfs.power_budget_mw),
        dvfs_adaptive=f32(float(soc.dvfs.adaptive)),
        thermal_predictive=f32(float(soc.thermal.predictive)),
        sec_enabled=f32(float(soc.security.enabled)),
        efficiency_factor=f32(sc.efficiency_factor),
        protocol_overhead=f32(sc.protocol_overhead),
        prefetch_overlap=f32(float(sc.prefetch_overlap)),
    )


StaticConfigs = Tuple[ucie_mod.UCIeConfig, dvfs_mod.DVFSConfig,
                      thermal_mod.ThermalConfig, SecurityConfig]


def _static_residual(soc: SoCConfig) -> StaticConfigs:
    """The sub-config fields `soc_params` does NOT lift (P-state tables,
    link energy constants, thermal trip points, AEAD costs, ...), with the
    lifted fields normalized out. Hashable: designs of one batch must share
    it, and `_configs_from_params` re-seeds the configs from it."""
    return (
        dataclasses.replace(soc.ucie, bandwidth_gbps=0.0, latency_us=0.0,
                            streaming=False, compression_ratio=0.0),
        dataclasses.replace(soc.dvfs, power_budget_mw=0.0, adaptive=False),
        dataclasses.replace(soc.thermal, r_k_per_w=(), c_j_per_k=(),
                            predictive=False),
        dataclasses.replace(soc.security, enabled=False),
    )


def _configs_from_params(p: SoCParams, static: StaticConfigs):
    """Rebuild the I1–I4 config objects: the lifted (per-design tensor)
    leaves over the static residual's remaining fields."""
    ucie_s, dvfs_s, thermal_s, sec_s = static
    ucie = dataclasses.replace(
        ucie_s,
        bandwidth_gbps=p.ucie_bandwidth_gbps,
        latency_us=p.ucie_latency_us,
        streaming=p.ucie_streaming > 0.5,
        compression_ratio=p.ucie_compression_ratio,
    )
    dvfs = dataclasses.replace(
        dvfs_s,
        power_budget_mw=p.dvfs_budget_mw,
        adaptive=p.dvfs_adaptive > 0.5,
    )
    thermal = dataclasses.replace(
        thermal_s,
        r_k_per_w=p.r_k_per_w,
        c_j_per_k=p.c_j_per_k,
        predictive=p.thermal_predictive > 0.5,
    )
    security = dataclasses.replace(sec_s, enabled=p.sec_enabled > 0.5)
    return ucie, dvfs, thermal, security


def _broadcast(p: SoCParams, rates: torch.Tensor):
    """Every per-design leaf expanded to the batch shape of (p, rates)."""
    batch = torch.broadcast_shapes(p.efficiency_factor.shape, rates.shape)

    def grow(name):
        x = getattr(p, name)
        if name in SoCParams.PER_CHIPLET:
            return x.expand(*batch, x.shape[-1]).contiguous()
        return x.expand(batch).contiguous()
    p = SoCParams(**{f.name: grow(f.name) for f in dataclasses.fields(p)})
    return p, rates.expand(batch).contiguous(), batch


def init_sim_state(n: int, dvfs_cfg, thermal_cfg, shape, device) -> SimState:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return SimState(
        dvfs=dvfs_mod.init_state(n, dvfs_cfg, shape, device),
        thermal=thermal_mod.init_state(thermal_cfg, shape, device),
        link=ucie_mod.init_link(shape, device),
        npu_queue_ms=torch.zeros((*shape, n), dtype=torch.float32,
                                 device=device),
        staged_images=z, completed=z, busy_ms=z, energy_mj=z,
        queue_integral=z,
    )


class _Tick:
    """One tick of the simulator for a whole batch. The constructor computes
    once what the reference's scan recomputes every tick but never changes
    (the arrival payload's transfer, the link capacity, the AEAD energy)."""

    def __init__(self, p: SoCParams, rates: torch.Tensor, *,
                 workload: Workload, npu_mask: Tuple[bool, ...],
                 static: StaticConfigs, tick_ms: float):
        self.p = p
        self.tick_ms = tick_ms
        dev = rates.device
        (self.ucie_cfg, self.dvfs_cfg, self.thermal_cfg,
         self.sec_cfg) = _configs_from_params(p, static)
        self.n_npu = sum(npu_mask)
        self.mask = constant(npu_mask, dev, torch.bool)
        self.maskf = self.mask.to(torch.float32)
        self.not_maskf = (~self.mask).to(torch.float32)
        # Per-image NPU compute cost at nominal clock (same calibration as the
        # closed-form model; ALPHA folds ISA/runtime overheads into NPU-ms).
        self.img_ms = ALPHA * workload.base_compute_ms \
            * workload.complexity_factor * p.efficiency_factor
        self.img_bytes = workload.input_size_mb * 1e6
        # arrivals per tick (rate · tick / 1e3) times the image's bytes
        payload = rates * const(tick_ms, recip(1e3), self.img_bytes)
        uvec = self.ucie_cfg.as_vector()
        _, self.link_energy, self.wire = ucie_mod.transfer(payload, uvec)
        self.capacity = ucie_mod.link_capacity(p.ucie_bandwidth_gbps, tick_ms)
        _, self.aead_e = aead_overhead(payload, self.sec_cfg)
        # wire bytes per staged image, times the protocol overhead that
        # stretches service: drained / a / b compiles to drained / (a · b)
        self.stage_den = torch.clamp(ucie_mod.to_wire_bytes(
            self.img_bytes * p.ucie_compression_ratio, p.ucie_streaming),
            min=1.0) * p.protocol_overhead
        self.npu_img_ms = (self.n_npu * self.img_ms)[..., None]
        self.img_ms_c = self.img_ms[..., None]
        self.inf = constant(float("inf"), dev)

    def __call__(self, state: SimState):
        p, tick_ms, mask = self.p, self.tick_ms, self.mask
        # --- I2/I3: activations cross the UCIe link (AEAD-sealed) ------------
        link, (drained, occupancy) = ucie_mod.drain(
            state.link, self.wire, self.link_energy, self.capacity)
        staged = state.staged_images + drained / self.stage_den

        # --- CPU dispatch: stage ready images onto the shorter NPU queue -----
        ready = staged - state.completed - (
            sum_last(state.npu_queue_ms * self.maskf) / self.img_ms)
        ready = torch.clamp(ready, min=0.0)
        npu_q = state.npu_queue_ms
        # split across NPUs inversely to queue depth
        qd = torch.where(mask, npu_q, self.inf)
        inv = torch.where(mask, torch.reciprocal(1.0 + qd), 0.0)
        frac = inv / torch.clamp(sum_last(inv), min=1e-9)[..., None]
        npu_q = fma(frac * ready[..., None], self.img_ms_c, npu_q)

        # --- I1: DVFS picks per-chiplet P-states ------------------------------
        demand = torch.where(
            mask,
            torch.clamp(npu_q / self.npu_img_ms, 0.0, 1.2),
            occupancy[..., None] * self.not_maskf,
        )
        dvfs_state, (freq, power_mw, _) = dvfs_mod.step(
            state.dvfs, demand, self.dvfs_cfg, p.peak_dyn_mw, p.static_mw,
            tick_ms)

        # --- I4: thermal integrate + predictive migration ---------------------
        thermal_state, (clock, npu_q) = thermal_mod.step(
            state.thermal, power_mw, mask, npu_q, self.thermal_cfg, tick_ms)

        # --- service ----------------------------------------------------------
        service = torch.where(mask, tick_ms * freq * clock, 0.0)
        done_ms = torch.minimum(npu_q, service)
        npu_q = npu_q - done_ms
        done = sum_last(done_ms)
        completed = state.completed + done / self.img_ms
        busy = state.busy_ms + done

        power_total = sum_last(power_mw)
        energy = fma(power_total, const(tick_ms, recip(1e3)),
                     state.energy_mj) + self.aead_e
        queue_integral = state.queue_integral + sum_last(npu_q) / self.img_ms

        new_state = SimState(
            dvfs=dvfs_state,
            thermal=thermal_state,
            link=link,
            npu_queue_ms=npu_q,
            staged_images=staged,
            completed=completed,
            busy_ms=busy,
            energy_mj=energy,
            queue_integral=queue_integral,
        )
        return new_state, (thermal_state.temp_c.amax(dim=-1), power_total)


def _simulate_params(
    p: SoCParams,
    arrival_rate_ips: torch.Tensor,
    *,
    workload: Workload,
    npu_mask: Tuple[bool, ...],
    static: StaticConfigs,
    ticks: int,
    tick_ms: float,
    eager: bool = False,
) -> Dict[str, torch.Tensor]:
    """Tensor core of `simulate` and `simulate_batch`: design points `p`
    (leaves of batch shape (...,), per-chiplet leaves (..., n)) against the
    arrival rates broadcast with them. Every metric has the broadcast batch
    shape. `npu_mask` and `static` (the non-lifted config fields) are shared
    by the batch. On the card the tick loop replays a captured block unless
    `eager`."""
    p, rates, batch = _broadcast(p, arrival_rate_ips.to(torch.float32))
    dev = rates.device
    n = p.peak_dyn_mw.shape[-1]
    n_npu = sum(npu_mask)
    duration_ms = ticks * tick_ms
    tick = _Tick(p, rates, workload=workload, npu_mask=npu_mask,
                 static=static, tick_ms=tick_ms)

    state = init_sim_state(n, tick.dvfs_cfg, tick.thermal_cfg, batch, dev)
    # per-tick observations, reduced as they come: the peak temperature
    # exactly, the mean power summed in f64
    peak_temp = torch.full(batch, -float("inf"), dtype=torch.float32,
                           device=dev)
    power_sum = torch.zeros(batch, dtype=torch.float64, device=dev)
    carry = (state, peak_temp, power_sum)
    if _captures(dev, eager) and ticks > TICK_BLOCK:
        carry = _replay_ticks(tick, carry, ticks)
    else:
        carry = _run_ticks(tick, carry, ticks)
    state, peak_temp, power_sum = carry

    dur_s = duration_ms / 1e3
    throughput = state.completed * recip(dur_s)
    # Little's law + link/attestation offsets for end-to-end latency. A
    # stalled design (zero throughput) reports inf, not 0 — sweeps must never
    # rank it best. The average queue (/ ticks) in ms (* 1e3) is one folded
    # factor.
    link_us = ucie_mod.transfer(
        torch.tensor(tick.img_bytes, dtype=torch.float32, device=dev),
        tick.ucie_cfg.as_vector())[0]
    latency_ms = (
        torch.where(throughput > 0,
                    state.queue_integral * const(recip(ticks), 1e3)
                    / torch.clamp(throughput, min=1e-30),
                    tick.inf)
        + tick.img_ms
        + torch.where(p.prefetch_overlap > 0.5, 0.0, link_us * recip(1e3))
    )
    return {
        "throughput_ips": throughput,
        "latency_ms": latency_ms,
        "avg_power_mw": (power_sum / ticks).to(torch.float32),
        "peak_temp_c": peak_temp,
        "energy_mj": state.energy_mj,
        "energy_mj_per_inf": state.energy_mj
        / torch.clamp(state.completed, min=1.0),
        "migrations": state.thermal.migrations,
        "throttle_ticks": state.thermal.throttle_ticks,
        "attestation_us": attestation_latency_us(n, tick.sec_cfg).expand(
            batch),
        "completed": state.completed,
        "npu_utilization": state.busy_ms * recip(n_npu * duration_ms),
    }


def _run_ticks(tick: _Tick, carry, n: int):
    """`n` ticks per op from carry (state, peak temperature, f64 power
    sum); returns the new carry."""
    state, peak_temp, power_sum = carry
    for _ in range(n):
        state, (temp_max, power_total) = tick(state)
        peak_temp = torch.maximum(peak_temp, temp_max)
        power_sum = power_sum + power_total.double()
    return state, peak_temp, power_sum


def _carry_leaves(carry):
    state, peak_temp, power_sum = carry
    leaves = []
    for sub in (state.dvfs, state.thermal, state.link, state):
        leaves += [getattr(sub, f.name) for f in dataclasses.fields(sub)
                   if isinstance(getattr(sub, f.name), torch.Tensor)]
    return leaves + [peak_temp, power_sum]


def _carry_from(carry, leaves):
    """A carry of carry's structure over `leaves` (`_carry_leaves` order)."""
    it = iter(leaves)
    state = carry[0]

    def take(sub):
        return dataclasses.replace(sub, **{
            f.name: next(it) for f in dataclasses.fields(sub)
            if isinstance(getattr(sub, f.name), torch.Tensor)})
    dvfs, thermal, link = (take(state.dvfs), take(state.thermal),
                           take(state.link))
    state = dataclasses.replace(take(state), dvfs=dvfs, thermal=thermal,
                                link=link)
    return state, next(it), next(it)


def _replay_ticks(tick: _Tick, carry, ticks: int):
    """The tick loop on the card: the ticks that do not fill a block per op
    (at least one: it makes the tick's constants), then one captured block
    of TICK_BLOCK ticks over static carry tensors, replayed for the rest."""
    blocks = (ticks - 1) // TICK_BLOCK
    carry = _run_ticks(tick, carry, ticks - blocks * TICK_BLOCK)
    replay, carry = captured_block(tick, carry)
    for _ in range(blocks):
        replay()
    return carry


def captured_block(tick: _Tick, carry):
    """One block of TICK_BLOCK ticks captured over static copies of
    `carry` (whose constants a per-op tick has made): (its replay, the
    static carry, which each replay advances in place)."""
    # static carry: one tensor a leaf (init_sim_state shares its zeros)
    static = [t.clone() for t in _carry_leaves(carry)]

    def block():
        out = _carry_leaves(_run_ticks(tick, _carry_from(carry, static),
                                       TICK_BLOCK))
        ptrs = {t.data_ptr() for t in static}
        # a leaf the block passed through unchanged from another leaf is
        # copied out before any write back
        out = [o.clone() if o.data_ptr() in ptrs and o is not dst else o
               for o, dst in zip(out, static)]
        for dst, o in zip(static, out):
            if o is not dst:
                dst.copy_(o)
    return _capture(block), _carry_from(carry, static)


def _captures(device: torch.device, eager: bool) -> bool:
    """Whether the tick loop replays captured blocks on `device`."""
    return device.type == "cuda" and not eager


def _capture(block):
    """Capture `block()` as a CUDA graph (the capture runs nothing); returns
    the graph's replay. A capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        block()
    return graph.replay


def _npu_mask(soc: SoCConfig) -> Tuple[bool, ...]:
    return tuple(c.kind == "npu" for c in soc.chiplets)


def simulate(
    soc: SoCConfig,
    workload: Workload,
    *,
    arrival_rate_ips: float,
    duration_ms: float = 200.0,
    device=None,
    eager: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run the SoC against a steady request stream; return summary metrics
    (0-d tensors): the 1 × 1 case of `simulate_batch`."""
    out = simulate_batch([soc], workload, [arrival_rate_ips],
                         duration_ms=duration_ms, device=device, eager=eager)
    return {k: v[0, 0] for k, v in out.items()}


def simulate_batch(
    socs: Sequence[SoCConfig],
    workload: Workload,
    arrival_rates_ips,
    *,
    duration_ms: float = 200.0,
    device=None,
    eager: bool = False,
) -> Dict[str, torch.Tensor]:
    """Sweep scenarios × arrival rates through one batched core.

    Args:
      socs: SoC design points; must share floorplan topology (chiplet kinds)
        and tick size — parameters may differ arbitrarily.
      workload: the workload model applied at every grid point.
      arrival_rates_ips: (R,) request rates to sweep.

    Returns the `simulate` metrics dict with every leaf shaped
    (len(socs), R). `latency_ms` is inf wherever a design stalls. On the
    card the tick loop replays captured blocks; `eager=True` runs every
    tick per op (the twin a captured run is held to, bit for bit).
    """
    device = resolve_device(device)
    socs = list(socs)
    assert socs, "simulate_batch needs at least one SoCConfig"
    kinds = tuple(c.kind for c in socs[0].chiplets)
    static = _static_residual(socs[0])
    for s in socs[1:]:
        assert tuple(c.kind for c in s.chiplets) == kinds, \
            "simulate_batch requires a shared floorplan topology"
        assert s.tick_ms == socs[0].tick_ms
        assert _static_residual(s) == static, \
            "simulate_batch sweeps only the lifted SoCParams fields; " \
            "non-lifted config fields (P-state tables, trip points, link " \
            "energy, AEAD costs) must match across designs"
    stacked = SoCParams.stack([soc_params(s, device) for s in socs])
    rates = torch.as_tensor(arrival_rates_ips, dtype=torch.float32,
                            device=device).reshape(-1)
    ticks = int(round(duration_ms / socs[0].tick_ms))
    fn = _batch_fn(workload, _npu_mask(socs[0]), static, ticks,
                   socs[0].tick_ms)
    return fn(stacked, rates, eager)


def simulate_designs(
    soc: SoCConfig,
    params: SoCParams,
    workload: Workload,
    arrival_rates_ips,
    *,
    duration_ms: float = 200.0,
    eager: bool = False,
) -> Dict[str, torch.Tensor]:
    """Sweep D design points × R arrival rates: `params` holds the designs'
    lifted leaves stacked on a leading axis (e.g. `scale_designs` around
    `soc_params(soc)`), and `soc` the floorplan and the non-lifted config
    they share. Runs on `params`' device; every metric is (D, R).
    `eager=True`: every tick per op, as in `simulate_batch`."""
    rates = torch.as_tensor(arrival_rates_ips, dtype=torch.float32,
                            device=params.efficiency_factor.device)
    ticks = int(round(duration_ms / soc.tick_ms))
    fn = _batch_fn(workload, _npu_mask(soc), _static_residual(soc), ticks,
                   soc.tick_ms)
    return fn(params, rates.reshape(-1), eager)


@functools.lru_cache(maxsize=None)
def _batch_fn(workload: Workload, npu_mask: Tuple[bool, ...],
              static: StaticConfigs, ticks: int, tick_ms: float):
    """The design × rate sweep for one static configuration: a function of
    (stacked SoCParams with leading axis S, rates (R,)) returning (S, R)
    metrics, as the reference's jitted double vmap is."""
    core = functools.partial(
        _simulate_params,
        workload=workload,
        npu_mask=npu_mask,
        static=static,
        ticks=ticks,
        tick_ms=tick_ms,
    )

    def fn(stacked: SoCParams, rates: torch.Tensor, eager: bool = False):
        # designs on axis 0, rates on axis 1, chiplets last
        p = stacked.map(lambda x: x.unsqueeze(1))
        return core(p, rates.reshape(1, -1), eager=eager)
    return fn
