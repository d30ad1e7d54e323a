"""Beyond-paper: design-space exploration over chiplet SoC configurations,
through the PyTorch port (`repro_torch.core`): the time-stepped simulator
batched over designs and rates, a 20,000-candidate sweep of the closed-form
model, a gradient co-design through autograd, and the ordering across
workloads. The same sections as `examples/design_space.py`, on the card
unless told otherwise.

  PYTHONPATH=src python examples/design_space_torch.py [--device cpu]
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

import torch                                       # noqa: E402

from repro_torch import prng, resolve_device       # noqa: E402
from repro_torch.core import perf_model as pm      # noqa: E402
from repro_torch.core.scenarios import (           # noqa: E402
    AI_OPTIMIZED, BASIC_CHIPLET, SCENARIO_ORDER, SCENARIOS, Scenario)
from repro_torch.core.soc import build_soc, simulate_batch  # noqa: E402
from repro_torch.core.workloads import MOBILENET_V2, WORKLOADS  # noqa: E402

FIELDS = Scenario.vector_fields()
# the co-designable knobs: link latency/bw, power envelope, efficiency,
# compression ratio
CODESIGN = [0, 1, 2, 4, 10]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sweep_time_stepped(device):
    """Every integration scenario × a 16-point load grid through the full
    time-stepped simulator (I1–I4 composed) in one batched call."""
    socs = [build_soc(SCENARIOS[s]) for s in SCENARIO_ORDER]
    rates = torch.linspace(25.0, 1500.0, 16)
    t0 = time.perf_counter()
    grid = simulate_batch(socs, MOBILENET_V2, rates, duration_ms=200.0,
                          device=device)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"time-stepped sweep: {len(socs)}x{rates.shape[0]} grid points "
          f"in {dt:.2f}s (one batched call)")
    i150 = int(torch.argmin(torch.abs(rates - 150.0)))
    rates = rates.to(device)
    print(f"{'scenario':18s} {'knee_ips':>9s} {'peak_thpt':>10s} "
          f"{'E/inf@' + f'{float(rates[i150]):.0f}':>10s} {'peakT':>6s}")
    for i, name in enumerate(SCENARIO_ORDER):
        lat = grid["latency_ms"][i]
        knee = float(torch.max(torch.where(lat <= 5.0, rates, 0.0)))
        print(f"{name:18s} {knee:9.0f} "
              f"{float(torch.max(grid['throughput_ips'][i])):10.0f} "
              f"{float(grid['energy_mj_per_inf'][i, i150]):10.2f} "
              f"{float(torch.max(grid['peak_temp_c'][i])):6.1f}")
    return grid


def candidate_sweep(base, wv, n=20_000):
    """The closed-form model at n designs, each field scaled by a factor in
    [0.7, 1.3] (the reference's draw: `jax.random.uniform(key(0), (n, 12))`);
    returns (candidates, TOPS/W, latency)."""
    factors = prng.uniform(prng.key(0).to(base.device), (n, base.shape[0]),
                           0.7, 1.3)
    cand = base[None, :] * factors
    r = pm.predict_vec(cand, wv, 1.0)
    return cand, r.tops_per_w, r.latency_ms


def codesign(base, wv, steps=300):
    """Projected gradient ascent on TOPS/W under a 10·max(latency − 5, 0)
    penalty, in a ±25 % box around `base`; returns (v0 result, v result,
    v)."""
    lo, hi = base * 0.75, base * 1.25
    lo, hi = torch.minimum(lo, hi), torch.maximum(lo, hi)
    mask = torch.zeros_like(base)
    mask[CODESIGN] = 1.0
    zero = torch.zeros((), device=base.device)
    v = base.clone()
    for _ in range(steps):
        v = v.detach().requires_grad_(True)
        r = pm.predict_vec(v, wv, 1.0)
        penalty = 10.0 * torch.maximum(r.latency_ms - 5.0, zero)
        objective = -(r.tops_per_w - penalty)
        (g,) = torch.autograd.grad(objective, v)
        with torch.no_grad():
            v = v - 0.05 * g * mask * torch.abs(v)
            v = torch.minimum(torch.maximum(v, lo), hi)
    with torch.no_grad():
        return pm.predict_vec(base, wv, 1.0), pm.predict_vec(v, wv, 1.0), v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (cpu runs the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    base = AI_OPTIMIZED.as_vector(device)
    wv = MOBILENET_V2.as_vector(device)

    # --- 0. time-stepped scenario × load sweep -----------------------------
    sweep_time_stepped(device)

    # --- 1. batched Monte-Carlo sweep ---------------------------------------
    n = 20_000
    cand, eff, lat = candidate_sweep(base, wv, n)
    feasible = lat <= 5.0                      # the paper's real-time budget
    best = int(torch.argmax(torch.where(feasible, eff, -torch.inf)))
    print(f"swept {n} candidate SoCs (one broadcast call)")
    print(f"feasible (≤5 ms): {int(torch.sum(feasible))} / {n}")
    print(f"best feasible TOPS/W: {float(eff[best]):.3f} "
          f"(paper AI-optimized: 0.284)")
    print("best design deltas vs AI-optimized:")
    for i, f in enumerate(FIELDS):
        ratio = float(cand[best, i] / torch.clamp(base[i], min=1e-9))
        if abs(ratio - 1) > 0.02 and base[i] > 0:
            print(f"  {f:22s} ×{ratio:.2f}")

    # --- 2. gradient co-design with a latency constraint -------------------
    r0, r1, v = codesign(base, wv)
    print("\ngradient co-design (±25% box, latency ≤ 5 ms):")
    print(f"  TOPS/W  {float(r0.tops_per_w):.4f} → {float(r1.tops_per_w):.4f}")
    print(f"  latency {float(r0.latency_ms):.2f} → {float(r1.latency_ms):.2f} ms")
    for i, f in enumerate(FIELDS):
        if base[i] > 0 and abs(float(v[i] / base[i]) - 1) > 0.02:
            print(f"  {f:22s} ×{float(v[i] / base[i]):.2f}")

    # --- 3. robustness: the AI-optimized ordering across every workload ----
    print("\nordering robustness across workloads (AI-opt vs basic):")
    for name, w in WORKLOADS.items():
        a = pm.predict(AI_OPTIMIZED, w, 1, device=device)
        b = pm.predict(BASIC_CHIPLET, w, 1, device=device)
        print(f"  {name:16s} Δlatency "
              f"{100*(1-float(a.latency_ms)/float(b.latency_ms)):+5.1f}%  "
              f"ΔTOPS/W {100*(float(a.tops_per_w)/float(b.tops_per_w)-1):+5.1f}%")


if __name__ == "__main__":
    main()
