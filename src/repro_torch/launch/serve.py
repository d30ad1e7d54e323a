"""Serving driver for the PyTorch port (port of `repro/launch/serve.py`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --requests 16 --slots 8 --max-len 1024 [--wdtype int8] [--kv-dtype int8]
      [--page-size 0] [--no-chunked-prefill] [--no-prefix-cache]
      [--temperature 0.8 --top-k 40 --top-p 0.95]

Runs the model at its full published width on the CUDA device unless
`--smoke` is given (the reduced same-family config) or `--device cpu`. The
weights are random, drawn from `--seed`: the repository holds no
checkpoints. `--wdtype int8 --kv-dtype int8` is the paper's int8 serving
numerics: int8 projections through the int8_matmul kernel and an int8 paged
KV pool with dequant fused into both attention kernels. `--page-size 0` is
the dense per-slot cache and `--no-chunked-prefill` the monolithic bucketed
prefill of a paged engine; both prefill whole prompts, through the dense
flash-attention kernel on the card. `--kv-dtype fp8` stores e5m2 rows in
the dense layout (`--page-size 0`), read by the decode kernel. `--arch
gemma-7b` (head_dim 256, GeGLU, (1+w) norms, scaled tied embeddings) and
`--arch chatglm3-6b` (32 query heads on 2 KV heads, qkv bias, rope on half
of each head) serve the dense family's other configs. `--arch
qwen2-moe-a2.7b` serves the moe family (60 routed experts top-4 and a
shared expert; with `--wdtype int8` every expert projection runs the
expert-batched int8_matmul), and `--arch deepseek-v2-lite` the moe family
with MLA latent attention (64 routed experts top-6, 2 shared; one 576-wide
latent row per token, read by the attention kernels), full width on the
card or `--smoke --device cpu`, and `--arch qwen2.5-32b` (64 layers,
d_model 5120) the largest dense config; `--arch llava-next-mistral-7b`
serves the vlm family (text-only prompts here) and `--arch
seamless-m4t-medium` the encdec family, each request with its own
standard-normal frames (cross_len x d_model) from the seed. The weights
are drawn one layer
slice at a time and, with `--wdtype int8`, each slice is quantized as it
is drawn (`ModelApi.init_int8`), so neither an f32 leaf nor the whole bf16
tree beside its int8 copy is ever held. The prefix cache is on by default
for paged chunked engines (`--no-prefix-cache` turns it off,
`--prefix-cache` asks for it); `--temperature > 0` samples every request,
request i with seed `--seed` + i.

Fault tolerance, as the reference's single-host flags: `--pages` sizes the
pool below the worst case (on one host admission stays FIFO and requests
queue for pages; preemption needs a requeued head, which the sharded
engine supplies), `--fault-seed` injects a seeded chaos plan (page
squeezes and restores; a single host has no shard to kill),
`--ttl-ticks` retires requests older than that many ticks and
`--max-queue` caps the admission queue. The sharded engine is ROADMAP A12.

`--arch mamba2-780m` (the ssm family) and `--arch recurrentgemma-2b` (the
hybrid family: RG-LRU blocks and windowed local attention) serve their
recurrent state in the dense layout, which the engine picks for them (the
page and chunk flags do not apply), with whole-tree weights. For them
`--int8` does what the reference CLI does: a generic int8 QDQ of the
2-D weights (`quantize_params_int8`) with float compute and f32 state;
the KV dtype is dropped.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.kernels.ref import quantize_weight_ref
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.tree import tree_map


def quantize_params_int8(params):
    """Weight-only int8 QDQ over generic 2-D weights (the reference CLI's
    `quantize_params_int8`): int8 numerics with float compute, for the
    recurrent families, which have no int8 engine datapath."""
    def qdq(p):
        if p.ndim == 2 and min(p.shape) >= 64:
            q, s = quantize_weight_ref(p.float())
            return (q.float() * s[None, :]).to(p.dtype)
        return p

    return tree_map(qdq, params)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (default: full width)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--int8", action="store_true",
                    help="shorthand for --wdtype int8 --kv-dtype int8")
    ap.add_argument("--wdtype", choices=["bf16", "int8"], default=None,
                    help="weight datapath (int8 = int8_matmul kernel)")
    ap.add_argument("--kv-dtype", choices=["f32", "bf16", "int8", "fp8"],
                    default=None,
                    help="KV pool storage (int8 = fused-dequant attention; "
                         "fp8 = e5m2 cast, dense layout / --page-size 0)")
    ap.add_argument("--page-size", type=int, default=32,
                    help="KV page size (0 = dense per-slot cache)")
    ap.add_argument("--pages", type=int, default=0,
                    help="pool pages incl. the null page (0 = worst case)")
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="monolithic bucketed prefill instead of the "
                         "chunked page-granular default (paged engines)")
    ap.add_argument("--chunk-pages", type=int, default=2,
                    help="prefill chunk size in pages (chunk = "
                         "chunk_pages x page_size tokens)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=None,
                    help="force the ref-counted prefix cache on (default: "
                    "auto, on for paged chunked engines, off under a "
                    "sliding window)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="disable prefix caching / copy-on-write pages")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k filter (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus top-p filter (1.0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="inject a seeded chaos plan (page squeezes and "
                         "restores); the same seed replays the same plan")
    ap.add_argument("--fault-rate", type=float, default=1.0,
                    help="chaos intensity: scales the plan's squeezes")
    ap.add_argument("--ttl-ticks", type=int, default=None,
                    help="retire requests older than this many engine ticks")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission-queue cap; submits beyond it raise "
                         "EngineOverloaded")
    args = ap.parse_args(argv)
    if args.kv_dtype == "fp8" and args.page_size != 0:
        ap.error("--kv-dtype fp8 is dense-layout only (paged e5m2 pools are "
                 "a recorded follow-on); pass --page-size 0")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg, device=args.device)
    wdtype = args.wdtype or ("int8" if args.int8 else None)
    kv_dtype = args.kv_dtype or ("int8" if args.int8 else None)
    if cfg.family in ("ssm", "hybrid"):
        params = model.init(args.seed)
        if wdtype == "int8":
            params, wdtype = quantize_params_int8(params), None
        kv_dtype = None if kv_dtype in ("int8", "bf16", "fp8") else kv_dtype
    elif wdtype == "int8":
        params = model.init_int8(args.seed)
    else:
        params = model.init(args.seed, by_layer=True)
    layout = {"paged": False} if args.page_size == 0 else {
        "page_size": args.page_size, "chunk_pages": args.chunk_pages,
        "n_pages": args.pages or None,
        "chunked_prefill": False if args.no_chunked_prefill else None,
        "prefix_cache": args.prefix_cache}
    fault_plan = None
    if args.fault_seed is not None:
        from repro_torch.serve.faults import chaos_plan
        # spread the events over the run's expected span of ticks
        n_ticks = max(16, args.requests * args.new_tokens
                      // max(1, args.slots) + 8)
        fault_plan = chaos_plan(args.fault_seed, n_shards=1, n_ticks=n_ticks,
                                deaths=0,
                                squeezes=max(1, round(3 * args.fault_rate)))
        print(f"[serve] fault plan seed={args.fault_seed}: "
              f"{fault_plan.counts()}")
    eng = ServeEngine(model, n_slots=args.slots, max_len=args.max_len,
                      params=params, device=model.device, wdtype=wdtype,
                      kv_dtype=kv_dtype,
                      fault_plan=fault_plan, ttl_ticks=args.ttl_ticks,
                      max_queue=args.max_queue, **layout)
    sample = None if args.temperature == 0 else (
        args.temperature, args.top_k, args.top_p)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(8, max(9, min(24, args.max_len // 2))))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        extras = None
        if cfg.family == "encdec":       # the stubbed audio frontend's rows
            extras = {"frames": rng.standard_normal(
                (cfg.cross_len, cfg.d_model)).astype(np.float32)}
        reqs.append(eng.submit(prompt, max_new_tokens=args.new_tokens,
                               sample_params=sample, seed=args.seed + i,
                               extras=extras))
    t0 = time.time()
    stats = eng.run_to_completion()
    wall = time.time() - t0
    done = sum(r.done for r in reqs)
    s = stats.summary()
    print(f"[serve] {cfg.name} on {model.device}: {done}/{len(reqs)} done  {s}")
    print(f"[serve] {stats.tokens_out / wall:.1f} tok/s  TTFT p50 "
          f"{1e3 * s['ttft_p50_s']:.0f} ms p99 {1e3 * s['ttft_p99_s']:.0f} ms"
          f"  wall {wall:.1f}s")
    return stats


if __name__ == "__main__":
    main()
