#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on the card.

    python tools/torch_train_profile.py                          # needs a CUDA card
    python tools/torch_train_profile.py --arch qwen2-moe-a2.7b [--layers N]
    python tools/torch_train_profile.py --arch all               # every config below
    python tools/torch_train_profile.py ... --eager              # the per-op twin

Default: chip_smoke.py's phase 4 run (smollm-360m at full width, bf16
params, global batch 8 x seq 512, the token source's batches and the train
loop's AdamW schedule). `--arch` takes a config of phase 4b
(`chip_smoke.TRAIN_FAMILIES`) at that phase's depth, batch and length
(qwen2-moe-a2.7b and deepseek-v2-lite at 4 layers, llava-next-mistral-7b at
8 with its 2880 patch rows at 4096 tokens, recurrentgemma-2b at 2 x 2560,
the rest at their full depth), its weights at their contraction fan-in and
its inputs from `registry.train_inputs`; `--layers` sets another depth.
Every step runs the train shape's options (`steps.train_options`: remat
'full', CE chunks of min(128, S), the reference attention, MoE groups of
min(64, S)).

The step runs as the train loop runs it (`steps.CapturedTrainStep`): a
CUDA graph built by the first step and replayed by every later one;
`--eager` profiles its per-op twin (`eager=True`). For the uncompressed
and the compressed-gradient step in turn: runs 2 warm-up steps (the build
and a first replay), times 3 steps without the profiler (host clock,
synchronized) and traces 3 more under torch.profiler. Every step has the
same shapes and the same work. Prints wall time per step, device kernel
time per step, the device's idle share (1 - kernel time / unprofiled wall
time; one stream, so kernels do not overlap), the host's launch calls per
step (a graph replay is one, `cudaGraphLaunch`, however many kernels it
holds), peak device memory allocated and reserved (the graph's pool is
reserved) and the kernels that take the most device time.
"""

from __future__ import annotations

import argparse
import gc
import math
import os
import sys
import time
from collections import Counter

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import (  # noqa: E402
    TRAIN_FAMILIES, contraction_fan_in, cut_depth)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenSource  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.models.registry import build_model, train_inputs  # noqa: E402
from repro_torch.train import compression  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402

BATCH, SEQ = 8, 512           # phase 4's smollm-360m run
WARM, TIMED, TRACED = 2, 3, 3
FAMILIES = {arch: (layers, batch, seq)
            for arch, layers, batch, seq, _ in TRAIN_FAMILIES}


def _device_times(prof):
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cuLaunchKernelEx", "cudaLaunchKernelExC",
                                "cudaGraphLaunch"))
    device = Counter()
    for e in events:
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t and e.device_type.name == "CUDA":
            device[e.key] += t
    return launches, device


def _batches(cfg, batch, seq, family: bool):
    """WARM + TIMED + TRACED batches: phase 4's token-source stream (numpy,
    staged as the train loop stages it), or phase 4b's one fixed batch of
    `train_inputs` (device tensors)."""
    n = WARM + TIMED + TRACED
    if family:
        return [train_inputs(cfg, batch, seq, seed=0)] * n
    src = TokenSource(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    return [src.batch_at(i) for i in range(n)]


def profile_step(model, batches, kw, compress: bool, family: bool,
                 eager: bool):
    from torch.profiler import ProfilerActivity, profile
    opt_cfg = opt_mod.OptimizerConfig(peak_lr=3e-4, warmup_steps=20,
                                      total_steps=WARM + TIMED + TRACED)
    grad_transform = compression.compress_grads if compress else None
    step_fn = steps_mod.make_train_step(model, opt_cfg, grad_transform, **kw)
    if family:
        params = contraction_fan_in(model.init(0), model.cfg)
        state = {"params": params, "opt": opt_mod.init_opt_state(params)}
    else:
        state = steps_mod.init_train_state(model, seed=0)
    step = steps_mod.CapturedTrainStep(step_fn, state, eager=eager)
    torch.cuda.reset_peak_memory_stats()
    for b in batches[:WARM]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[WARM:WARM + TIMED]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TIMED
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[WARM + TIMED:]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) / TRACED
    launches, device = _device_times(prof)
    busy = sum(device.values()) / 1e6 / TRACED
    tokens = math.prod(batches[0]["tokens"].shape)
    if (step.builds, step.captured) != (1, not eager) \
            or step.replays != (0 if eager else WARM + TIMED + TRACED - 1):
        raise RuntimeError(f"step program: builds {step.builds}, replays "
                           f"{step.replays}, captured {step.captured}")
    print(f"{model.cfg.name} {'compressed' if compress else 'uncompressed'} "
          f"step, {'eager' if eager else 'captured'}: wall "
          f"{1e3 * wall:.1f} ms/step ({1e3 * traced_wall:.1f} "
          f"under the profiler) = {tokens / wall:.0f} tokens/s; device "
          f"kernel time {1e3 * busy:.1f} ms/step; device idle share "
          f"{1 - busy / wall:.3f}; host launches {launches / TRACED:.0f}/step; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB "
          "reserved", flush=True)
    for name, us in device.most_common(10):
        print(f"  {us / 1e3 / TRACED:8.3f} ms/step  {name[:100]}")
    del step, state, prof


def run(arch: str, layers=None, eager: bool = False):
    family = arch in FAMILIES
    if family:
        cut, batch, seq = FAMILIES[arch]
        layers = cut if layers is None else layers
    else:
        batch, seq = BATCH, SEQ
    cfg = get_config(arch)
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    opts, kw = steps_mod.train_options(seq)
    model = build_model(cfg, opts)
    depth = (f"{cfg.n_enc_layers} + {cfg.n_dec_layers}"
             if cfg.family == "encdec" else cfg.n_layers)
    print(f"[{torch.cuda.get_device_name(0)}] {arch}: {depth} layers, "
          f"batch {batch} x seq {seq}", flush=True)
    batches = _batches(cfg, batch, seq, family)
    for compress in (False, True):
        profile_step(model, batches, kw, compress, family, eager)
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    help="smollm-360m (phase 4), a config of phase 4b, or "
                         "'all' for every phase 4b config")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers to run (default: the phase's depth)")
    ap.add_argument("--eager", action="store_true",
                    help="profile the per-op twin (default: the captured "
                         "step's replays)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if args.arch != "all" and args.arch != "smollm-360m" \
            and args.arch not in FAMILIES:
        ap.error(f"--arch {args.arch}: not a config of phase 4 or 4b")
    for arch in (FAMILIES if args.arch == "all" else [args.arch]):
        run(arch, args.layers, args.eager)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
