#!/usr/bin/env python3
"""Time the port's int8_matmul kernel at every K split it could take, on the card.

    python tools/torch_int8_sweep.py [--m 8 64 512 1024]   # needs a CUDA card
    python tools/torch_int8_sweep.py --batched


For each M and each smollm-360m projection (K, N), forces `plan` to every
admissible split length (GEMV: multiples of 16 up to 256 rows; tensor
cores: whole 64-row K steps) and prints the kernel's device time (CUDA
events, L2 evicted before each call, as chip_smoke.py's `time_ms`) beside
`torch.matmul` on the dequantized weight, and the split the default `plan`
picks. Also times one tiny elementwise kernel: the floor a single launch
reads under this method.

`--batched` times the expert-batched kernel instead, at qwen2-moe-a2.7b's
experts (E 60; w1/w3 and w2 at M 64 and 8, bf16 x): the same plan run as
split blocks and as walking blocks, in turns (split, walk, walk, split),
beside `torch.bmm` on the bf16 weights; both ways' outputs are held equal
bit for bit first.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import (INT8_KN, MOE_EXPERT_KN, MOE_EXPERT_M, QWEN,  # noqa: E402
                        time_ms)
from repro_torch.kernels import int8_matmul as mmod  # noqa: E402
from repro_torch.kernels.ref import (quantize_channelwise_ref,  # noqa: E402
                                    quantize_weight_ref)


def batched(gen) -> int:
    """Split blocks against walking blocks at the MoE expert shapes."""
    default = mmod.batched_plan
    e = QWEN["experts"]
    for wname, k, n in MOE_EXPERT_KN:
        w = torch.randn(e, k, n, generator=gen, device="cuda") / k ** 0.5
        wq, s = quantize_channelwise_ref(w, (1,))
        s = s[:, 0].contiguous()
        wd = (wq.float() * s[:, None, :]).to(torch.bfloat16)
        del w
        for m in MOE_EXPERT_M:
            x = torch.randn(e, m, k, generator=gen,
                            device="cuda").to(torch.bfloat16)
            p = default(e, m, k, n, x.dtype)

            def run(walk):
                mmod.batched_plan = lambda *a: p._replace(walk=walk)
                try:
                    return mmod.int8_matmul_batched_cuda(x, wq, s)
                finally:
                    mmod.batched_plan = default
            if not torch.equal(run(False).view(torch.int16),
                               run(True).view(torch.int16)):
                print(f"{wname} M{m}: split and walking blocks differ")
                return 1
            t = {False: [], True: []}
            for walk in (False, True, True, False):
                t[walk].append(time_ms(lambda: run(walk)))
            lib = time_ms(lambda: torch.bmm(x, wd))
            print(f"{wname} E{e} M{m} K{k} N{n} {p.path} {p.splits} splits "
                  f"of {p.ks}: split blocks ({p._replace(walk=False).blocks(e, m, n)}) "
                  f"{t[False][0]:.4f} {t[False][1]:.4f} ms; walking blocks "
                  f"({p._replace(walk=True).blocks(e, m, n)}) {t[True][0]:.4f} "
                  f"{t[True][1]:.4f} ms; bmm {lib:.4f} ms", flush=True)
        del wq, wd
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, nargs="+", default=[8, 64, 512, 1024])
    ap.add_argument("--batched", action="store_true",
                    help="split against walking blocks at the MoE experts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.batched:
        return batched(gen)
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
