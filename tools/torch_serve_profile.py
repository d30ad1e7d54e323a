#!/usr/bin/env python3
"""Where a serving tick of the PyTorch port spends its time, on the card.

    python tools/torch_serve_profile.py [--int8] [--dense]   # needs a CUDA card
    python tools/torch_serve_profile.py --sample   # run (i)'s sampled decode
    python tools/torch_serve_profile.py --arch qwen2-moe-a2.7b [--int8]
    python tools/torch_serve_profile.py --arch deepseek-v2-lite [--int8]
    python tools/torch_serve_profile.py --arch gemma-7b|chatglm3-6b [--int8]
    python tools/torch_serve_profile.py --arch qwen2.5-32b [--int8]
    python tools/torch_serve_profile.py --arch llava-next-mistral-7b|seamless-m4t-medium [--int8]
    python tools/torch_serve_profile.py --arch mamba2-780m|recurrentgemma-2b
    python tools/torch_serve_profile.py --shards 4 [--int8]
    python tools/torch_serve_profile.py ... --eager   # the per-op twin

Serves chip_smoke.py's traffic (smollm-360m at full width, 12 prompts of
32–768 tokens from default_rng(0), 8 slots, page 32, chunk 64) on two
engines that hold the same weights and the same queue. The engines are
deterministic, so after 30 warm-up ticks on each they stand in the same
state, and ticks 31-40 run the same prefill chunks and decode steps on both:
the first engine times them without the profiler, the second runs them under
torch.profiler. With `--dense` the engines are chip_smoke.py's runs (c)/(d),
a dense cache with monolithic prefill; their prefills all fall in a few
ticks, so the window is the whole run (every tick) of a second wave of the
same traffic, after each engine has served it once to build (and capture)
every step and warm everything. Prints wall time per tick (both runs; the profiler slows the
host), device kernel time per tick, the device's idle share (1 - kernel time
/ unprofiled wall time of the same ticks; one stream, so kernels do not
overlap), kernel launches per tick, the eight kernels that take the most
device time and, below them, the port's own kernels (csrc/*.cu).
With `--arch qwen2-moe-a2.7b` the engines serve chip_smoke.py's runs (e)/(f)
(qwen2-moe-a2.7b at full width, the first 8 prompts, 16 new tokens each),
with `--arch deepseek-v2-lite` its runs (k)/(l) (MLA: one latent pool, int8
or bf16, read by the attention kernels; the same traffic), with `--arch
gemma-7b` or `--arch chatglm3-6b` phase 3e's runs ((o)/(q) and (s)/(u);
`--dense`: (p)/(r) and (t)/(v); all 12 prompts, 16 new tokens each), with
`--arch qwen2.5-32b` phase 3f's runs ((y) bf16 weights from the by-layer
draw and f32 KV, `--int8` (w) int8 weights from `init_int8` and int8 KV,
`--int8 --dense` (x); the same traffic, weights drawn layer by layer as
chip_smoke.py draws them, so the bf16 tree and an int8 copy never
coexist); with `--arch llava-next-mistral-7b` or `--arch
seamless-m4t-medium` phase 3g's runs ((la)/(lc) and (sa)/(sd); `--dense`:
(lb)/(ld) and (sb), the latter with int8 weights and KV, which
chip_smoke.py does not run) on their traffic: llava at chip_smoke.py's
VLM_LAYERS, 8 requests with their patch rows in 4096-row slots, 16 new
tokens; seamless at full depth, 12 requests with their frames in 512-row
slots, 32 new tokens.
With `--arch mamba2-780m` or `--arch recurrentgemma-2b` the engines are
phase 3h's (ma) and (ra): full width (mamba2-780m at chip_smoke.py's
MAMBA_LAYERS), bf16 weights, f32 state, 8 dense slots, the model's
traffic (`chip_smoke.recurrent_traffic`: 13 requests of 32 new tokens, or
14 of 16); as with `--dense` their
admissions prefill whole prompts, so the window is the whole run after a
warm-up run.
With `--shards N` the engines are phase 3i's sharded engines ((sh1), with
`--int8` (sh2)): smollm-360m's 12 prompts over N shards of one page pool
(8 slots, page 32, chunk 64), one global decode step a tick.
With `--sample` the requests are run (i)'s: even positions at temperature 0
with top_k 40 / top_p 0.95, odd ones at (0.8, 40, 0.95), seeds 100 + i, so
every decode step with an odd request live runs the batched sampler.

The engines capture their decode and chunk steps, their monolithic prefill
and paste (one step a bucket) and their page moves as CUDA graphs (built in
the warm-up ticks or wave and replayed in the window; the recurrent
families' exact-length prefill runs per op); `--eager` profiles their
per-op twins (`eager=True`). Launches per tick count the host's launch
calls: a graph replay is one (`cudaGraphLaunch`), however many kernels it
holds.
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

from chip_smoke import (  # noqa: E402
    LLAVA, MAMBA, RGEMMA, SEAMLESS, VLM_LAYERS, contraction_fan_in,
    cut_depth, fan_in_transform, llava_traffic, recurrent_traffic,
    seamless_traffic)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.quantized import quantize_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

# the __global__ functions of src/repro_torch/csrc/*.cu
PORT_KERNELS = ("decode_split_kernel", "decode_wide_kernel", "chunk_mma_kernel",
                "chunk_wide_kernel", "chunk_attention_kernel", "flash_mma_kernel",
                "flash_wide_kernel", "flash_kernel", "gemv_kernel", "tc_kernel",
                "quantize_blocks_kernel", "dequantize_blocks_kernel")
# phase 3e's runs: (paged, dense) x (bf16 weights / f32 KV, int8 / int8)
WIDE_RUNS = {"gemma-7b": ("(o)", "(q)", "(p)", "(r)"),
             "chatglm3-6b": ("(s)", "(u)", "(t)", "(v)"),
             "qwen2.5-32b": ("(y)", "(w)", "dense bf16", "(x)"),
             "llava-next-mistral-7b": ("(la)", "(lc)", "(lb)", "(ld)"),
             "seamless-m4t-medium": ("(sa)", "(sd)", "(sb)",
                                     "dense int8")}
# phase 3g's models: their traffic and slots come from chip_smoke.py
PHASE_3G = ("llava-next-mistral-7b", "seamless-m4t-medium")
# phase 3h's: the recurrent families
PHASE_3H = {MAMBA["arch"]: MAMBA, RGEMMA["arch"]: RGEMMA}
WARM, TRACED = 30, 10     # ticks 31-40 are timed on one engine, traced on the other


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=["smollm-360m", "qwen2-moe-a2.7b",
                             "deepseek-v2-lite", "gemma-7b", "chatglm3-6b",
                             "qwen2.5-32b", *PHASE_3G, *PHASE_3H])
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights and int8 KV pool (run (b), (e) or "
                         "(k))")
    ap.add_argument("--dense", action="store_true",
                    help="dense cache and monolithic prefill (runs (c)/(d)), "
                         "profiled over the whole run")
    ap.add_argument("--sample", action="store_true",
                    help="run (i)'s mixed greedy / sampled requests")
    ap.add_argument("--eager", action="store_true",
                    help="the engines' per-op twins (no CUDA graphs)")
    ap.add_argument("--shards", type=int, default=0,
                    help="phase 3i's sharded engine over N shards "
                         "(smollm-360m, paged chunked)")
    args = ap.parse_args()
    if args.shards and (args.arch != "smollm-360m" or args.dense):
        ap.error("--shards serves smollm-360m paged and chunked")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(args.arch)
    if cfg.family == "vlm":
        cfg = cut_depth(cfg, VLM_LAYERS)
    if args.arch in PHASE_3H:
        cfg = cut_depth(cfg, PHASE_3H[args.arch]["serve_layers"])
    moe = cfg.family == "moe"
    n_req, n_new = (8, 16) if moe else (12, 16 if args.arch in WIDE_RUNS
                                         else 32)
    if args.arch == "seamless-m4t-medium":
        n_new = 32
    recurrent = PHASE_3H.get(args.arch)
    if recurrent:
        n_new = recurrent["new"]
        args.dense = True           # whole prompts at admission
    model = build_model(cfg)
    # the weights chip_smoke.py serves: qwen2.5-32b's drawn by layer, the
    # earlier models' whole-tree stream
    by_layer = args.arch == "qwen2.5-32b"
    if by_layer and args.int8:
        params = model.init_int8(seed=0, transform=fan_in_transform(cfg))
    elif by_layer:
        params = model.init(seed=0, dtype=torch.bfloat16, by_layer=True,
                            transform=fan_in_transform(cfg))
    else:
        params = contraction_fan_in(model.init(seed=0), cfg)
    mla = cfg.attn_kind == "mla"
    kw = dict(kv_dtype="int8") if args.int8 else (
        dict(kv_dtype="bf16") if mla else {})   # (l): a bf16 latent pool
    if args.int8 and not by_layer:
        # quantized once for every engine (the engines' wdtype="int8" pass,
        # done here): the float copies of the quantized leaves are freed
        params = quantize_params(params, cfg)
    kw.update(dict(paged=False, chunked_prefill=False) if args.dense
              else dict(page_size=32, chunk_pages=2))
    max_len = 1024
    if recurrent:
        _, prompts, extras = recurrent_traffic(recurrent)
        max_len = recurrent["max_len"]
    elif cfg.family == "vlm":
        _, prompts, extras = llava_traffic(params["embed"].float().std().item())
        max_len = LLAVA["max_len"]
    elif cfg.family == "encdec":
        _, prompts, extras = seamless_traffic()
        max_len = SEAMLESS["max_len"]
    else:
        rng = np.random.default_rng(0)
        lens = [int(x) for x in rng.integers(32, 769, 12)]
        prompts = [rng.integers(0, 49152, n).astype(np.int32)
                   for n in lens][:n_req]
        extras = [None] * len(prompts)
    if args.shards:
        from repro_torch.launch.mesh import make_serve_mesh
        from repro_torch.serve.sharded import ShardedServeEngine
        kw.pop("page_size"), kw.pop("chunk_pages")
        engines = [ShardedServeEngine(
            model, mesh=make_serve_mesh(args.shards, device=model.device),
            n_slots=8, max_len=max_len, params=params, page_size=32,
            chunk_pages=2, eager=args.eager, **kw) for _ in range(2)]
    else:
        engines = [ServeEngine(model, n_slots=8, max_len=max_len,
                               params=params, eager=args.eager, **kw)
                   for _ in range(2)]

    def submit(eng):
        return [eng.submit(
            p, max_new_tokens=n_new, seed=100 + i, extras=x,
            sample_params=((0.8, 40, 0.95) if i % 2 else (0.0, 40, 0.95))
            if args.sample else None)
            for i, (p, x) in enumerate(zip(prompts, extras))]
    if args.dense:
        for eng in engines:       # the warm-up wave: every step built
            submit(eng)
            eng.run_to_completion()
    reqs = [submit(eng) for eng in engines]
    if args.dense:
        warm, n_ticks = 0, 10_000
    else:
        warm, n_ticks = WARM, TRACED
    timed, traced = engines
    for eng in engines:
        for _ in range(warm):
            eng.step()
    before = [(e.stats.decode_steps, e.stats.prefill_chunks, e.stats.prefills)
              for e in engines]

    def run(eng):
        ticks = 0
        queue = eng._sched.queue if args.shards else eng._queue
        while ticks < n_ticks and (queue or any(eng._slots)):
            eng.step()
            ticks += 1
        return ticks

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = run(timed)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traced_ticks = run(traced)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    work = [(e.stats.decode_steps - s0, e.stats.prefill_chunks - c0,
             e.stats.prefills - p0, t)
            for e, (s0, c0, p0), t in zip(engines, before, (ticks, traced_ticks))]
    tokens = [[r.out_tokens for r in rs] for rs in reqs]
    if before[0] != before[1] or work[0] != work[1] or tokens[0] != tokens[1]:
        print(f"the two engines diverged: {before} {work}", file=sys.stderr)
        return 1
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
    busy_s = sum(device.values()) / 1e6
    label = {(False, False): "(a) bf16", (True, False): "(b) int8",
             (False, True): "(c) dense bf16", (True, True): "(d) dense int8"}
    runs = ("(k) int8", "(l) bf16") if mla else ("(e) int8", "(f) bf16")
    if recurrent:
        name = f"{cfg.name} ({recurrent['run']}) bf16, f32 state"
    elif moe:
        name = f"{cfg.name} {runs[0] if args.int8 else runs[1]}"
    elif args.arch in WIDE_RUNS:
        run = WIDE_RUNS[args.arch][2 * args.dense + args.int8]
        name = f"{cfg.name} {run} {'int8' if args.int8 else 'bf16'}"
    else:
        name = label[args.int8, args.dense]
    if args.shards:
        name = (f"{'(sh2) int8' if args.int8 else '(sh1) bf16'}, "
                f"{args.shards} shards")
    if by_layer:
        name += (f"; peak device memory "
                 f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if args.sample:
        name += ", (i)'s sampled requests"
    name += ", eager" if args.eager else ", captured"
    print(f"{name}: ticks {warm + 1}-{warm + ticks} "
          f"({work[0][0]} decode steps, {work[0][1]} prefill chunks, "
          f"{work[0][2]} admissions) timed on one engine and traced on its "
          "twin")
    print(f"wall per tick {1e3 * plain_wall / ticks:.2f} ms "
          f"({1e3 * wall / ticks:.2f} ms under the profiler); device kernel "
          f"time per tick {1e3 * busy_s / ticks:.2f} ms; device idle share "
          f"{1 - busy_s / plain_wall:.3f}; kernel launches per tick "
          f"{launches / ticks:.0f}")
    top = device.most_common(8)
    # and the port's own kernels (csrc/*.cu) that fall outside the top 8
    top += [(n, us) for n, us in device.most_common()[8:]
            if any(f"::{k}{c}" in n for k in PORT_KERNELS for c in "<(")]
    for name, us in top:
        print(f"  {us / 1e3 / ticks:8.3f} ms/tick  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
