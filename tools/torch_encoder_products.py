#!/usr/bin/env python3
"""seamless-m4t-medium's admission-time products on the card: the encoder
and the cross K/V as one call each, or in 64-row blocks.

    python tools/torch_encoder_products.py   # needs a CUDA card

The port runs the encoder's and the cross K/V's products as one call each
(`quantized.one_product`): they always run cross_len rows, so one call fixes
a row's bits as the 64-row blocks of `quantized.fixed_row_blocks` would.
This times both ways on chip_smoke.py's phase 3g model (full width and
depth, attention projections at contraction fan-in) and traffic (12
requests with frames of their own, 32 new tokens, 8 slots of 512 rows),
with bf16 and with int8 weights:

- `prefill_cross` per admission: wall ms (CUDA-synchronised, frames already
  on the card), the median of the 12 requests; kernel launches of one
  admission (torch.profiler);
- the paged chunked engine's whole run, (sa) (bf16 weights, f32 KV) and
  (sd) (int8 weights and KV): wall seconds, tokens/s and TTFT p50.

"blocks" is the port's code with `one_product` replaced by a null context.
The ways run in the order one, blocks, blocks, one, after a warm-up run that
builds the kernels, and each number is the mean of its two runs. Prints
whether the two ways give the same ck/cv bits and the same tokens.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import (  # noqa: E402
    SEAMLESS, SERVE_NEW_TOKENS, SMOLLM, contraction_fan_in, seamless_traffic)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.quantized import quantize_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ONE_PRODUCT = encdec.one_product
LAUNCH_EVENTS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaLaunchKernelExC")


@contextlib.contextmanager
def way(name):
    """The encoder's products as one call ("one") or in row blocks."""
    encdec.one_product = ONE_PRODUCT if name == "one" \
        else contextlib.nullcontext
    try:
        yield
    finally:
        encdec.one_product = ONE_PRODUCT


def admissions(model, params, frames):
    """(median wall ms of prefill_cross over the frames, the last ck/cv)."""
    ms, out = [], None
    with torch.no_grad():
        for fr in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.prefill_cross(params, {"frames": fr})
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ms), out


def launches(model, params, fr):
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        model.prefill_cross(params, {"frames": fr})
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in LAUNCH_EVENTS)


def serve(model, params, prompts, extras, **kw):
    """(wall s, tokens/s, TTFT p50 s, tokens) of the paged chunked run."""
    eng = ServeEngine(model, n_slots=SMOLLM["slots"],
                      max_len=SEAMLESS["max_len"], params=params,
                      page_size=SMOLLM["page"],
                      chunk_pages=SMOLLM["chunk"] // SMOLLM["page"], **kw)
    reqs = [eng.submit(p, max_new_tokens=SERVE_NEW_TOKENS, extras=x)
            for p, x in zip(prompts, extras)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (wall, stats.tokens_out / wall, stats.summary()["ttft_p50_s"],
            [r.out_tokens for r in reqs])


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    cfg = get_config("seamless-m4t-medium")
    model = build_model(cfg)
    params = contraction_fan_in(model.init(seed=0), cfg)
    _, prompts, extras = seamless_traffic()
    frames = [torch.as_tensor(x["frames"]).cuda()[None] for x in extras]
    order = ("one", "blocks", "blocks", "one")
    for wname, wparams, kw in (
            ("bf16", params, {}),
            ("int8", quantize_params(params, cfg),
             dict(wdtype="int8", kv_dtype="int8"))):
        serve(model, params, prompts, extras, **kw)      # warm-up, builds
        admissions(model, wparams, frames[:2])
        adm, run, bits, toks, n_launch = {}, {}, {}, {}, {}
        for name in order:
            with way(name):
                ms, out = admissions(model, wparams, frames)
                adm.setdefault(name, []).append(ms)
                bits[name] = out
                wall, tps, ttft, tok = serve(model, params, prompts, extras,
                                             **kw)
                run.setdefault(name, []).append((wall, tps, ttft))
                toks[name] = tok
                n_launch[name] = launches(model, wparams, frames[0])
        same_bits = all(torch.equal(bits["one"][k], bits["blocks"][k])
                        for k in ("ck", "cv"))
        same_toks = sum(a == b for a, b in zip(toks["one"], toks["blocks"]))
        for name in ("one", "blocks"):
            r = run[name]
            print(f"[encoder] {wname} weights, {name}: prefill_cross "
                  f"{statistics.mean(adm[name]):.3f} ms an admission "
                  f"(runs {', '.join(f'{x:.3f}' for x in adm[name])}), "
                  f"{n_launch[name]} launches; chunked run "
                  f"{statistics.mean(x[0] for x in r):.3f} s, "
                  f"{statistics.mean(x[1] for x in r):.1f} tokens/s, TTFT "
                  f"p50 {statistics.mean(x[2] for x in r):.4f} s (runs "
                  f"{', '.join(f'{x[0]:.3f}' for x in r)} s)")
        print(f"[encoder] {wname} weights: ck/cv bit-equal between the two "
              f"ways: {same_bits}; streams equal {same_toks}/{len(prompts)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
