#!/usr/bin/env python3
"""Time the port's int8_matmul kernel at every K split it could take, on the card.

    python tools/torch_int8_sweep.py [--m 8 64 512 1024]   # needs a CUDA card

For each M and each smollm-360m projection (K, N), forces `plan` to every
admissible split length (GEMV: multiples of 16 up to 256 rows; tensor
cores: whole 64-row K steps) and prints the kernel's device time (CUDA
events, L2 evicted before each call, as chip_smoke.py's `time_ms`) beside
`torch.matmul` on the dequantized weight, and the split the default `plan`
picks. Also times one tiny elementwise kernel: the floor a single launch
reads under this method.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import INT8_KN, time_ms  # noqa: E402
from repro_torch.kernels import int8_matmul as mmod  # noqa: E402
from repro_torch.kernels.ref import quantize_weight_ref  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, nargs="+", default=[8, 64, 512, 1024])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    tiny = torch.zeros(8, device="cuda")
    print(f"one tiny elementwise kernel: {time_ms(lambda: tiny.add_(1)):.4f} ms")
    default_plan = mmod.plan
    for m in args.m:
        for k, n in INT8_KN:
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            wq, s = quantize_weight_ref(
                torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5)
            s = s.contiguous()
            wd = (wq.float() * s[None, :]).to(torch.bfloat16)
            lib = time_ms(lambda: torch.matmul(x, wd))
            p0 = default_plan(m, k, n, x.dtype)
            if p0.path == "gemv":
                cands = [("gemv", ks) for ks in sorted(
                    {ks for ks in range(16, 257, 16) if -(-k // ks) <= 64}
                    | {p0.ks})]
            else:
                cands = [("mma", 64 * t) for t in range(1, -(-k // 64) + 1)
                         if t <= 8 or t * 64 >= k or t % 4 == 0]
            row = []
            for path, ks in cands:
                mmod.plan = lambda *a, ks=ks, path=path: mmod.Plan(
                    path, ks, -(-k // ks))
                try:
                    t = time_ms(lambda: mmod.int8_matmul_cuda(x, wq, s))
                finally:
                    mmod.plan = default_plan
                row.append(f"{path}/{ks}:{t:.4f}")
            print(f"M{m} K{k} N{n} default {p0.path} ks {p0.ks} "
                  f"(splits {p0.splits}); matmul {lib:.4f}; path/ks:ms "
                  + " ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
