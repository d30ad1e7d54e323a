#!/usr/bin/env python3
"""Where a serving engine's decode rows part from the one-slot oracle, on
the card.

    python tools/torch_row_diff.py [--window 256] [--int8 | --fp8]
                                   [--prompt I | --prompt all]

Serves a prompt of chip_smoke.py's traffic (default the first, 658
tokens; smollm-360m at full width, the same seeded weights) on the paged
chunked engine (8 slots, page 32; with `--fp8` chip_smoke's run (n): the
dense engine with monolithic bucketed prefill and an e5m2 cache) and on
`generate_greedy`'s engine (one slot, dense, exact-length prefill, the same
cache dtype), both keeping logits, and prints the first decode step whose
logits are not bit-equal and where the streams part. At that step it
records the input and output row of every `rms_norm`, projection
(`qeinsum`), activation and decode attention (its query row in, its row
out) of both engines and prints the first op whose inputs are equal and
outputs are not.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402


class OpLog:
    """Wraps the model's per-row ops; while `on`, records (op, input row,
    output row) of sequence 0 of every call."""

    def __init__(self):
        self.on, self.ops = False, []
        transformer.qeinsum = self.wrap("qeinsum", transformer.qeinsum, 1)
        transformer.rms_norm = self.wrap("rms_norm", transformer.rms_norm, 0)
        attn = transformer.attn_mod
        attn.decode_attention = self.wrap("decode_attention",
                                          attn.decode_attention, 0)
        act = transformer.act_fn
        transformer.act_fn = lambda name: self.wrap("act", act(name), 0)

    def wrap(self, name, fn, arg):
        def op(*a, **k):
            out = fn(*a, **k)
            if self.on:
                self.ops.append((name, a[arg][0].clone(), out[0].clone()))
            return out
        return op


def decode_rows(args, index):
    cfg = get_config("smollm-360m")
    model = build_model(dataclasses.replace(cfg, window=args.window))
    params = cs.contraction_fan_in(model.init(seed=0), cfg)
    _, prompts = cs.serve_traffic()
    prompt = prompts[index]
    kw, layout = {}, {}
    if args.int8:
        kw = dict(wdtype="int8", kv_dtype="int8")
    if args.fp8:
        kw = dict(kv_dtype="fp8")
        layout = dict(paged=False, chunked_prefill=False)

    def engines():
        oracle = ServeEngine(model, n_slots=1, max_len=cs.SMOLLM["max_len"],
                             params=params, bucket_prompts=False, paged=False,
                             keep_logits=True, device=model.device, **kw)
        return oracle, cs._engine(model, params, True, **layout, **kw)

    runs = []
    for eng in engines():
        runs.append(eng.submit(prompt, max_new_tokens=cs.SERVE_NEW_TOKENS))
        eng.run_to_completion()
    ro, re_ = runs
    step = next((t for t, (a, b) in enumerate(zip(re_.logits, ro.logits))
                 if not torch.equal(a, b)), None)
    part = next((t for t, (a, b) in enumerate(zip(re_.out_tokens,
                                                  ro.out_tokens)) if a != b),
                None)
    weights = "int8" if args.int8 else "bf16"
    cache = "fp8, dense monolithic" if args.fp8 else kw.get("kv_dtype", "f32")
    label = (f"prompt {index} plen {prompt.shape[0]}, window {args.window}, "
             f"{weights} weights, {cache} cache")
    print(f"[row_diff] {label}: first step with logits not bit-equal {step}"
          f", streams part at step {part}")
    if step is None:
        return 0
    log = OpLog()
    traces = []
    for eng in engines():
        r = eng.submit(prompt, max_new_tokens=cs.SERVE_NEW_TOKENS)
        while len(r.out_tokens) < step:
            eng.step()
        log.on, log.ops = True, []
        eng.step()
        log.on = False
        traces.append(log.ops)
    for i, ((name, xa, ya), (_, xb, yb)) in enumerate(zip(*traces)):
        if torch.equal(xa, xb) and not torch.equal(ya, yb):
            print(f"[row_diff] step {step}: op {i} of {len(traces[0])} "
                  f"({name}, input {tuple(xa.shape)} {xa.dtype}) has equal "
                  f"inputs and outputs that differ by at most "
                  f"{(ya.float() - yb.float()).abs().max().item():.4g} "
                  "between the one-slot oracle and the 8-slot engine")
            return 0
    print(f"[row_diff] step {step}: no op with equal inputs and unequal "
          "outputs among the recorded ones")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights and KV (default: bf16 weights, f32 KV)")
    ap.add_argument("--fp8", action="store_true",
                    help="run (n): bf16 weights, e5m2 cache, the dense "
                         "engine with monolithic prefill")
    ap.add_argument("--prompt", default="0",
                    help="index into chip_smoke's traffic, or 'all'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build()
    indices = range(cs.SERVE_REQUESTS) if args.prompt == "all" \
        else [int(args.prompt)]
    for i in indices:
        decode_rows(args, i)
    return 0


if __name__ == "__main__":
    sys.exit(main())
