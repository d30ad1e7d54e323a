"""Serving driver for the PyTorch port (port of `repro/launch/serve.py`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --requests 16 --slots 8 --max-len 1024 [--wdtype int8] [--kv-dtype int8]

Runs the model at its full published width on the CUDA device unless
`--smoke` is given (the reduced same-family config) or `--device cpu`. The
weights are random, drawn from `--seed`: the repository holds no
checkpoints. `--wdtype int8 --kv-dtype int8` is the paper's int8 serving
numerics: int8 projections through the int8_matmul kernel and an int8 paged
KV pool with dequant fused into both attention kernels.

Only the engine options this port has are flags here; the sharded engine,
fault plans, sampling and the prefix cache come with later ROADMAP items.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine


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
    ap.add_argument("--kv-dtype", choices=["f32", "bf16", "int8"],
                    default=None,
                    help="KV pool storage (int8 = fused-dequant attention)")
    ap.add_argument("--page-size", type=int, default=32, help="KV page size")
    ap.add_argument("--chunk-pages", type=int, default=2,
                    help="prefill chunk size in pages (chunk = "
                         "chunk_pages x page_size tokens)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    eng = ServeEngine(model, n_slots=args.slots, max_len=args.max_len,
                      params=params, device=model.device,
                      wdtype=args.wdtype or ("int8" if args.int8 else None),
                      kv_dtype=args.kv_dtype or ("int8" if args.int8 else None),
                      page_size=args.page_size, chunk_pages=args.chunk_pages)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(args.requests):
        plen = int(rng.integers(8, max(9, min(24, args.max_len // 2))))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        reqs.append(eng.submit(prompt, max_new_tokens=args.new_tokens))
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
