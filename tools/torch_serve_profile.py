#!/usr/bin/env python3
"""Where a serving tick of the PyTorch port spends its time, on the card.

    python tools/torch_serve_profile.py [--int8]   # needs a CUDA card

Serves chip_smoke.py's traffic (smollm-360m at full width, 12 prompts of
32–768 tokens from default_rng(0), 8 slots, page 32, chunk 64) on two
engines that hold the same weights and the same queue. The engines are
deterministic, so after 30 warm-up ticks on each they stand in the same
state, and ticks 31-40 run the same prefill chunks and decode steps on both:
the first engine times them without the profiler, the second runs them under
torch.profiler. Prints wall time per tick (both runs; the profiler slows the
host), device kernel time per tick, the device's idle share (1 - kernel time
/ unprofiled wall time of the same ticks; one stream, so kernels do not
overlap), kernel launches per tick and the kernels that take the most device
time.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import Counter

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import contraction_fan_in  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

WARM, TRACED = 30, 10     # ticks 31-40 are timed on one engine, traced on the other


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights and int8 KV pool (run (b))")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("smollm-360m")
    model = build_model(cfg)
    params = contraction_fan_in(model.init(seed=0), cfg)
    kw = dict(wdtype="int8", kv_dtype="int8") if args.int8 else {}
    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.integers(32, 769, 12)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    timed, traced = (ServeEngine(model, n_slots=8, max_len=1024, params=params,
                                 page_size=32, chunk_pages=2, **kw)
                     for _ in range(2))
    reqs = []
    for eng in (timed, traced):
        reqs.append([eng.submit(p, max_new_tokens=32) for p in prompts])
        for _ in range(WARM):
            eng.step()
    before = [(e.stats.decode_steps, e.stats.prefill_chunks)
              for e in (timed, traced)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRACED):
        timed.step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            traced.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    work = [(e.stats.decode_steps - s0, e.stats.prefill_chunks - c0)
            for e, (s0, c0) in zip((timed, traced), before)]
    tokens = [[r.out_tokens for r in rs] for rs in reqs]
    if before[0] != before[1] or work[0] != work[1] or tokens[0] != tokens[1]:
        print(f"the two engines diverged: {before} {work}", file=sys.stderr)
        return 1
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cuLaunchKernelEx", "cudaLaunchKernelExC"))
    device = Counter()
    for e in events:
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t and e.device_type.name == "CUDA":
            device[e.key] += t
    busy_s = sum(device.values()) / 1e6
    print(f"{'(b) int8' if args.int8 else '(a) bf16'}: ticks {WARM + 1}-"
          f"{WARM + TRACED} ({work[0][0]} decode steps, {work[0][1]} prefill "
          "chunks) timed on one engine and traced on its twin")
    print(f"wall per tick {1e3 * plain_wall / TRACED:.2f} ms "
          f"({1e3 * wall / TRACED:.2f} ms under the profiler); device kernel "
          f"time per tick {1e3 * busy_s / TRACED:.2f} ms; device idle share "
          f"{1 - busy_s / plain_wall:.3f}; kernel launches per tick "
          f"{launches / TRACED:.0f}")
    for name, us in device.most_common(8):
        print(f"  {us / 1e3 / TRACED:8.3f} ms/tick  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
