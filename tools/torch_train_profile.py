#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on the card.

    python tools/torch_train_profile.py      # needs a CUDA card

Builds chip_smoke.py's train run (smollm-360m at full width, bf16 params,
global batch 8 x seq 512, remat 'full', CE chunk 128, the train loop's
AdamW schedule) and, for the uncompressed and the compressed-gradient step
in turn: runs 2 warm-up steps, times 3 steps without the profiler (host
clock, synchronized) and traces 3 more under torch.profiler. Every step has
the same shapes and the same work. Prints wall time per step, device kernel
time per step, the device's idle share (1 - kernel time / unprofiled wall
time; one stream, so kernels do not overlap), kernel launches per step and
the kernels that take the most device time.
"""

from __future__ import annotations

import os
import sys
import time
from collections import Counter

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenSource  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.transformer import ExecOptions  # noqa: E402
from repro_torch.train import compression  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402

BATCH, SEQ = 8, 512
WARM, TIMED, TRACED = 2, 3, 3


def _device_times(prof):
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
    return launches, device


def profile_step(model, compress: bool):
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    opt_cfg = opt_mod.OptimizerConfig(peak_lr=3e-4, warmup_steps=20,
                                      total_steps=WARM + TIMED + TRACED)
    grad_transform = ((lambda g: compression.compress_decompress(g)[0])
                      if compress else None)
    step_fn = steps_mod.make_train_step(model, opt_cfg, grad_transform,
                                        ce_chunk=min(128, SEQ), remat="full")
    state = steps_mod.init_train_state(model, seed=0)
    src = TokenSource(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0))
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in src.batch_at(i).items()}
               for i in range(WARM + TIMED + TRACED)]
    for b in batches[:WARM]:
        state, _ = step_fn(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[WARM:WARM + TIMED]:
        state, _ = step_fn(state, b)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TIMED
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[WARM + TIMED:]:
            state, _ = step_fn(state, b)
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) / TRACED
    launches, device = _device_times(prof)
    busy = sum(device.values()) / 1e6 / TRACED
    print(f"{'compressed' if compress else 'uncompressed'} step: wall "
          f"{1e3 * wall:.1f} ms/step ({1e3 * traced_wall:.1f} under the "
          f"profiler) = {BATCH * SEQ / wall:.0f} tokens/s; device kernel time "
          f"{1e3 * busy:.1f} ms/step; device idle share {1 - busy / wall:.3f}; "
          f"kernel launches {launches / TRACED:.0f}/step; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for name, us in device.most_common(10):
        print(f"  {us / 1e3 / TRACED:8.3f} ms/step  {name[:100]}")


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    # the train loop's attention (`launch/train.py`): the reference
    model = build_model(get_config("smollm-360m"),
                        ExecOptions(attn_impl="reference"))
    for compress in (False, True):
        profile_step(model, compress)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
