#!/usr/bin/env python3
"""Where a tick of the port's SoC simulator spends its time, on the card.

    python tools/torch_soc_profile.py                 # chip_smoke.py (j4)'s batch
    python tools/torch_soc_profile.py --designs 0     # (j3)'s hot 4 x 16 grid
    python tools/torch_soc_profile.py --eager         # the per-op tick loop
    python tools/torch_soc_profile.py --device cpu --designs 8   # a rehearsal

Builds the batch of one of `chip_smoke.py`'s phase-5 runs (MobileNetV2,
2,000-tick runs at 0.1 ms): with `--designs N` (default 4,096) N designs
around ai_optimized, every continuous lifted leaf scaled by
`prng.uniform(key(0), (N, 30), 0.8, 1.2)`, x the 16 rates 25-1500 images/s
((j4)); with `--designs 0` the hot variant of the 4 scenarios x the 16
rates ((j3)). It runs the batched core's tick (`repro_torch.core.soc._Tick`)
for 100 warm-up ticks, then `--ticks` ticks timed on the host clock, then as
many again under torch.profiler. On the card the timed and traced ticks
replay one captured block of `TICK_BLOCK` ticks (`core.soc.captured_block`,
as `simulate_batch` does; `--ticks` rounds down to whole blocks), with
`--eager` (and on the CPU) they run per op. Prints wall ms per tick (both
runs), device kernel ms per tick, the device's idle share (1 - kernel time
/ unprofiled wall time; one stream), host launches per tick (a graph
replay is one) and the kernels that take the most device time.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import Counter

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import prng, resolve_device            # noqa: E402
from repro_torch.core import soc as tsoc                 # noqa: E402
from repro_torch.core.scenarios import SCENARIO_ORDER, SCENARIOS  # noqa: E402
from repro_torch.core.workloads import MOBILENET_V2      # noqa: E402


def batch_tick(designs: int, device):
    """(the tick, its initial state, simulations in the batch)."""
    rates = torch.linspace(25.0, 1500.0, 16, device=device)
    if designs:
        soc = tsoc.build_soc(SCENARIOS["ai_optimized"])
        factors = prng.uniform(prng.key(0, device=device), (designs, 30),
                               0.8, 1.2)
        stacked = tsoc.scale_designs(tsoc.soc_params(soc, device), factors)
    else:
        socs = [tsoc.hot_variant(tsoc.build_soc(SCENARIOS[s]))
                for s in SCENARIO_ORDER]
        soc = socs[0]
        stacked = tsoc.SoCParams.stack([tsoc.soc_params(s, device)
                                        for s in socs])
    p, rates, shape = tsoc._broadcast(stacked.map(lambda x: x.unsqueeze(1)),
                                      rates.reshape(1, -1))
    tick = tsoc._Tick(p, rates, workload=MOBILENET_V2,
                      npu_mask=tsoc._npu_mask(soc),
                      static=tsoc._static_residual(soc), tick_ms=soc.tick_ms)
    state = tsoc.init_sim_state(p.peak_dyn_mw.shape[-1], tick.dvfs_cfg,
                                tick.thermal_cfg, shape, device)
    return tick, state, rates.numel()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--designs", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--device", default=None)
    ap.add_argument("--eager", action="store_true",
                    help="the per-op tick loop (no captured block)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tick, state, sims = batch_tick(args.designs, device)
    shape = state.staged_images.shape
    carry = (state, torch.full(shape, -float("inf"), device=device),
             torch.zeros(shape, dtype=torch.float64, device=device))
    carry = tsoc._run_ticks(tick, carry, 100)
    if cuda and not args.eager:
        replay, carry = tsoc.captured_block(tick, carry)
        block = tsoc.TICK_BLOCK
        args.ticks = max(block, args.ticks // block * block)

        def ticks():
            for _ in range(args.ticks // block):
                replay()
    else:
        def ticks():
            tsoc._run_ticks(tick, carry, args.ticks)
    sync()
    t0 = time.perf_counter()
    ticks()
    sync()
    plain_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ticks()
        sync()
        traced_s = time.perf_counter() - t0
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cuLaunchKernelEx", "cudaLaunchKernelExC",
                                "cudaGraphLaunch"))
    kernels = Counter()
    for e in events:
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t and e.device_type.name == "CUDA":
            kernels[e.key] += t
    busy_s = sum(kernels.values()) / 1e6
    what = (f"{args.designs} designs x 16 rates" if args.designs
            else "the hot variant's 4 scenarios x 16 rates")
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    how = "per op" if args.eager or not cuda else \
        f"as replays of a captured {tsoc.TICK_BLOCK}-tick block"
    print(f"{what} = {sims} simulations, {args.ticks} ticks {how} after 100 "
          f"warm-up ticks, on {name}")
    print(f"wall per tick {1e3 * plain_s / args.ticks:.3f} ms "
          f"({1e3 * traced_s / args.ticks:.3f} ms under the profiler) = "
          f"{sims * args.ticks / plain_s:.0f} simulation-ticks/s")
    if not cuda:
        print("device time: not measured (no card)")
        return 0
    print(f"device kernel time per tick {1e3 * busy_s / args.ticks:.3f} ms; "
          f"device idle share {1 - busy_s / plain_s:.3f}; host launches "
          f"per tick {launches / args.ticks:.1f}")
    for key, us in kernels.most_common(8):
        print(f"  {us / 1e3 / args.ticks:8.4f} ms/tick  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
