"""Closed-form chiplet SoC performance model (port of `repro/core/perf_model.py`).

Per (scenario s, workload w, batch b):

    T_compute(b) = alpha * C_w * chi_w * eps_s * (1 + (b-1)*eta_w) / (clock*boost)
    T_comm(b)    = (ell_s/1000 + 8*S_w*b*cr_s/B_s) * rho_s          [ms]
    T_total(b)   = T_compute(b) + [no prefetch overlap] * T_comm(b)
    u(b)         = 1 - (1-u0)/b                      (NPU duty cycle)
    clock        = min(1, tau_s/u(b)) unless predictive migration holds it at 1
    P(b)         = P0_s*v_s^2*(sigma_s + (1-sigma_s)*u(b)*clock) + Pc_s*T_comm(b)
    thpt         = 1000*b/T_total ;  TOPS/W = thpt*GOP/P ;  E = P*T_total/b

`predict_vec` broadcasts over leading axes (the reference vmaps it), so one
call evaluates a whole design grid; gradients go through autograd. Every
division by a constant divides by a tensor: CUDA's `x / scalar` multiplies by
the scalar's reciprocal, which is not the correctly rounded quotient the
reference computes. Ties of `min`/`max` split the gradient as JAX does
(`torch.minimum`/`torch.maximum`, not `torch.clamp`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch import prng, resolve_device
from repro_torch.core.scenarios import Scenario
from repro_torch.core.workloads import Workload

# Calibrated once on the Monolithic batch-1 MobileNetV2 row (4.7 ms):
#   ALPHA = 4.7 / (3.5 * 0.8)
ALPHA = 1.6785714285714286
# Calibrated batch-1 NPU duty cycle (power model; fits all 4 scenario rows):
BASE_UTIL = 0.75
# DVFS boost engages fully once power headroom reaches this fraction (I1).
DVFS_HEADROOM_FULL = 0.10
# Predictive thermal management (I4) adds migration headroom on top of the
# throttle threshold: load shifts to the second NPU chiplet before derating.
MIGRATION_HEADROOM = 0.25


@dataclasses.dataclass
class PerfResult:
    """Model outputs; every field is a tensor of the broadcast batch shape."""

    latency_ms: torch.Tensor       # end-to-end per-batch latency
    throughput_ips: torch.Tensor   # images (inferences) per second
    power_mw: torch.Tensor         # average power draw
    tops_per_w: torch.Tensor       # paper's efficiency metric
    energy_mj: torch.Tensor        # energy per inference, millijoule
    utilization: torch.Tensor      # NPU duty cycle u(b)
    clock_scale: torch.Tensor      # thermal derating factor (1 = no throttle)
    t_compute_ms: torch.Tensor
    t_comm_ms: torch.Tensor        # raw (pre-overlap) transfer time
    realtime_ok: torch.Tensor      # bool: per-image latency meets the deadline


def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 constant on `like`'s device (a divisor that divides exactly)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def predict_vec(
    scen_vec: torch.Tensor,
    work_vec: torch.Tensor,
    batch_size,
    *,
    alpha: float = ALPHA,
    base_util: float = BASE_UTIL,
    realtime_deadline_ms: float = 5.0,
) -> PerfResult:
    """Vector-encoded model: `scen_vec` (..., 12), `work_vec` (..., 5) and
    `batch_size` broadcast over their leading axes. See
    `Scenario.as_vector` for the layout."""
    (ell, bw, p0, pc, eps, tau, sigma, v, rho, overlap, cr, boost_max) = [
        scen_vec[..., i] for i in range(12)
    ]
    c, s_mb, chi, eta, gops = [work_vec[..., i] for i in range(5)]
    b = torch.as_tensor(batch_size, dtype=torch.float32, device=scen_vec.device)
    one = _c(1.0, b)

    # --- utilization & thermal derating (I4) ---------------------------------
    u = 1.0 - _c(1.0 - base_util, b) / b
    # Predictive migration raises the effective throttle ceiling (AI-optimized
    # keeps clock=1 while a reactive design derates once u exceeds tau).
    tau_eff = tau + MIGRATION_HEADROOM * (boost_max > 0.0).float()
    clock = torch.minimum(one, tau_eff / torch.maximum(u, _c(1e-6, b)))

    # --- communication (I2) ---------------------------------------------------
    t_comm = (ell / _c(1000.0, b) + 8.0 * s_mb * b * cr / bw) * rho  # ms

    # --- power (pre-boost, to derive DVFS headroom non-self-referentially) ---
    p_nominal = p0 * (v * v) * (sigma + (1.0 - sigma) * u * clock) + pc * t_comm
    headroom = 1.0 - p_nominal / (p0 * (v * v))
    boost = 1.0 + boost_max * torch.minimum(
        torch.maximum(headroom / _c(DVFS_HEADROOM_FULL, b), _c(0.0, b)), one)

    # --- compute --------------------------------------------------------------
    t_compute = alpha * c * chi * eps * (1.0 + (b - 1.0) * eta) / (clock * boost)
    t_total = t_compute + (1.0 - overlap) * t_comm

    thpt = 1000.0 * b / t_total
    power = p_nominal  # boost spends the headroom; envelope unchanged
    tops_per_w = (thpt * gops * 1e9) / (power / _c(1000.0, b)) / _c(1e12, b)
    energy_mj = power * t_total / b / _c(1000.0, b)  # mW*ms = uJ; /1000 = mJ
    per_image_ms = t_total / b

    shape = torch.broadcast_shapes(scen_vec.shape[:-1], work_vec.shape[:-1],
                                   b.shape)
    return PerfResult(
        latency_ms=t_total,
        throughput_ips=thpt,
        power_mw=power,
        tops_per_w=tops_per_w,
        energy_mj=energy_mj,
        utilization=u.expand(shape),
        clock_scale=clock.expand(shape),
        t_compute_ms=t_compute,
        t_comm_ms=t_comm.expand(shape),
        realtime_ok=per_image_ms <= realtime_deadline_ms,
    )


def predict(
    scenario: Scenario,
    workload: Workload,
    batch_size=1,
    *,
    alpha: float = ALPHA,
    base_util: float = BASE_UTIL,
    device=None,
) -> PerfResult:
    """Typed front-end over `predict_vec`."""
    device = resolve_device(device)
    return predict_vec(
        scenario.as_vector(device),
        workload.as_vector(device),
        torch.as_tensor(batch_size, dtype=torch.float32, device=device),
        alpha=alpha,
        base_util=base_util,
        realtime_deadline_ms=workload.realtime_deadline_ms,
    )


def predict_grid(
    scenarios: Sequence[Scenario],
    workloads: Sequence[Workload],
    batch_sizes: Sequence[int],
    *,
    device=None,
) -> PerfResult:
    """Full (n_scenarios, n_workloads, n_batches) grid in one broadcast call."""
    device = resolve_device(device)
    sv = torch.stack([s.as_vector(device) for s in scenarios])   # (S, 12)
    wv = torch.stack([w.as_vector(device) for w in workloads])   # (W, 5)
    bs = torch.as_tensor(batch_sizes, dtype=torch.float32, device=device)
    return predict_vec(sv[:, None, None, :], wv[None, :, None, :],
                       bs[None, None, :])


def predict_noisy(
    key: torch.Tensor,
    scenario: Scenario,
    workload: Workload,
    batch_size: int = 1,
    *,
    n_runs: int = 32,
    noise_frac: float = 0.05,
    device=None,
) -> PerfResult:
    """Monte-Carlo runs with multiplicative gaussian measurement noise; `key`
    is a `prng.key` (the draws equal `jax.random.normal(key, (2, n_runs))`).

    The paper reports single-run numbers with +/-0.2-0.3 ms spread; this models
    that spread so tests can assert reproduction within the paper's own bars.
    """
    device = resolve_device(device)
    base = predict(scenario, workload, batch_size, device=device)
    eps_lat, eps_pow = prng.normal(key.to(device), (2, n_runs))
    lat = base.latency_ms * (1.0 + noise_frac * eps_lat)
    pow_ = base.power_mw * (1.0 + noise_frac * eps_pow)
    b = torch.as_tensor(batch_size, dtype=torch.float32, device=device)
    thpt = 1000.0 * b / lat
    return dataclasses.replace(
        base,
        latency_ms=lat,
        power_mw=pow_,
        throughput_ips=thpt,
        tops_per_w=(thpt * workload.gops_per_inference * 1e9)
        / (pow_ / _c(1000.0, b))
        / _c(1e12, b),
        energy_mj=pow_ * lat / b / _c(1000.0, b),
        realtime_ok=(lat / b) <= workload.realtime_deadline_ms,
    )
