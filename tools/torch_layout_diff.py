#!/usr/bin/env python3
"""Where chunked and monolithic prefill part, stage by stage, on the card.

    python tools/torch_layout_diff.py [--arch smollm-360m] [--prompt 0]
    python tools/torch_layout_diff.py --arch deepseek-v2-lite --prompt 1
    python tools/torch_layout_diff.py --smoke --device cpu   # a rehearsal

Takes one prompt of `chip_smoke.serve_traffic()` (the first: 658 tokens)
through two serving engines built on the same full-width random weights
(`chip_smoke.contraction_fan_in` applied): the paged engine with chunked
prefill (64-row chunks, the chunk-prefill kernel) and the dense engine with
monolithic bucketed prefill (one 1024-row pass, the dense flash kernel).
Both prefill only; no decode step runs. Done twice: bf16 weights with an
f32 KV cache (bf16 for an MLA model, as chip_smoke.py's run (l)), and int8
weights with an int8 KV cache. A moe model's monolithic engine groups its
MoE tokens in the chunk's 64 rows (`ExecOptions(moe_group=64)`, as
chip_smoke.py's run (m)), so both engines route and drop alike.

For every layer it prints, over the prompt's rows, the max |difference| and
the number of differing elements and bits of each stage: the q, k and v
projections, the K and V rows the two caches hold (pool bytes against the
dense cache's bytes, int8 scales included), the attention core's output,
the o-projection, the FFN and the layer's output (the residual stream). An
MLA model has no q/k/v projections of its own and one latent pool: its
stages are the latent rows the caches hold, the attention core, the
o-projection (wv_b and wo), the FFN and the residual. Then the first
stage, in layer and stage order, that differs.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

STAGES = ("q", "k", "v", "k_cache", "v_cache", "attn", "o_proj", "ffn",
          "residual")
MLA_STAGES = ("k_cache", "attn", "o_proj", "ffn", "residual")


class Recorder:
    """Wraps the transformer's stage functions; each call's output rows are
    kept per (stage, layer), in call order. Every stage function runs once
    per layer per forward pass, in layer order."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        self.rows = defaultdict(list)
        self.calls = defaultdict(int)
        self.saved = []

    def _keep(self, stage, t):
        layer = self.calls[stage] % self.n_layers
        self.calls[stage] += 1
        self.rows[(stage, layer)].append(t.detach().reshape(t.shape[1], -1))

    def patch(self):
        from repro_torch.models import attention as attn_mod
        from repro_torch.models import transformer as tmod
        rec = self

        depth = defaultdict(int)

        def wrap(mod, name, keep, nest=None):
            """`nest`: of wrapped calls that share it, only the outermost
            keeps its output (MLA's `latent_attention` calls `attention`
            on the CPU)."""
            orig = getattr(mod, name)

            def fn(*a, **kw):
                depth[nest] += 1
                try:
                    out = orig(*a, **kw)
                finally:
                    depth[nest] -= 1
                if nest is None or depth[nest] == 0:
                    keep(out)
                return out
            self.saved.append((mod, name, orig))
            setattr(mod, name, fn)

        def qkv(out):
            for stage, t in zip(("q", "k", "v"), out):
                rec._keep(stage, t)
        wrap(tmod, "_project_qkv", qkv)
        # the attention core: (B, S, H, 1, D) dense, (B, C, KV, G, D) chunk
        for name in ("attention", "latent_attention", "chunk_attention_paged"):
            wrap(attn_mod, name, lambda o: rec._keep("attn", o), nest="attn")
        wrap(tmod, "attn_block", lambda out: rec._keep("o_proj", out[0]))
        wrap(tmod, "dense_ffn", lambda o: rec._keep("ffn", o))
        try:                           # the moe family, where it exists
            from repro_torch.models import moe as moe_mod
            wrap(moe_mod, "moe_ffn", lambda o: rec._keep("ffn", o))
        except ImportError:
            pass
        wrap(tmod, "layer_fn", lambda out: rec._keep("residual", out[0]))

    def restore(self):
        for mod, name, orig in reversed(self.saved):
            setattr(mod, name, orig)
        self.saved = []

    def stage(self, stage, layer, n):
        import torch
        return torch.cat(self.rows[(stage, layer)], dim=0)[:n]


def _bits(t):
    import torch
    if t.dtype in (torch.float32, torch.int32):
        return t.view(torch.int32).long() & 0xFFFFFFFF
    if t.dtype in (torch.bfloat16, torch.float16, torch.int16):
        return t.view(torch.int16).long() & 0xFFFF
    return t.view(torch.int8).long() & 0xFF


def compare(a, b):
    """(max |a - b|, differing elements, differing bits)."""
    x = _bits(a) ^ _bits(b)
    nbits = 0
    v = x.clone()
    while bool(v.any()):
        nbits += int((v & 1).sum())
        v >>= 1
    err = (a.float() - b.float()).abs().max().item() if a.numel() else 0.0
    return err, int((x != 0).sum()), nbits


def prefill(model, params, prompt, label, n_layers, **engine_kw):
    """Prefill `prompt` in one engine, no decode; returns the recorder and
    the prompt's cache rows {key: (L, plen, ...)}."""
    import torch
    from chip_smoke import SMOLLM
    from repro_torch.serve.engine import ServeEngine
    c = SMOLLM
    eng = ServeEngine(model, n_slots=c["slots"], max_len=c["max_len"],
                      params=params, page_size=c["page"],
                      chunk_pages=c["chunk"] // c["page"], device=model.device,
                      **engine_kw)
    rec = Recorder(n_layers)
    rec.patch()
    try:
        eng.submit(prompt, max_new_tokens=1)
        eng._admit()
        while eng.chunked and eng._prefill_fifo:
            eng._prefill_tick()
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        rec.restore()
    plen = prompt.shape[0]
    cache = {}
    for key in ("k", "v", "ks", "vs"):
        if key not in eng._cache:
            continue
        pool = eng._cache[key]
        if eng.paged:
            idx = torch.arange(plen, device=pool.device)
            pages = eng._cache["page_table"][0].long()[idx // eng.page_size]
            cache[key] = pool[:, pages, idx % eng.page_size]
        else:
            cache[key] = pool[:, 0, :plen]
    print(f"[diff] {label}: prefill of {plen} rows, "
          f"{eng.stats.prefill_chunks} chunks, pad rows "
          f"{eng.stats.prefill_pad_tokens}", flush=True)
    return rec, cache


def diff(model, model_m, params, prompt, n_layers, label, **kw):
    """Chunked prefill on `model`, monolithic on `model_m`; prints every
    stage's differences and returns the first differing one."""
    chunk, cache_c = prefill(model, params, prompt, f"{label} chunked",
                             n_layers, **kw)
    mono, cache_m = prefill(model_m, params, prompt, f"{label} monolithic",
                            n_layers, paged=False, chunked_prefill=False,
                            **kw)
    stages = MLA_STAGES if model.cfg.attn_kind == "mla" else STAGES
    plen = prompt.shape[0]
    first = None
    print(f"[diff] {label}: layer stage max|d| differing-elements "
          "differing-bits (of the prompt's rows)")
    for layer in range(n_layers):
        for stage in stages:
            if stage in ("k_cache", "v_cache"):
                key = stage[0]
                results = [compare(cache_c[key][layer], cache_m[key][layer])]
                if key + "s" in cache_c:
                    results.append(compare(cache_c[key + "s"][layer],
                                           cache_m[key + "s"][layer]))
                err = max(r[0] for r in results)
                n_el = sum(r[1] for r in results)
                n_bit = sum(r[2] for r in results)
            else:
                a = chunk.stage(stage, layer, plen)
                b = mono.stage(stage, layer, plen)
                err, n_el, n_bit = compare(a, b)
            if n_el and first is None:
                first = (layer, stage, err, n_el, n_bit)
            if layer < 2 or layer == n_layers - 1 or n_el:
                print(f"[diff] {label} L{layer:02d} {stage:9s} {err:.6g} "
                      f"{n_el} {n_bit}")
    if first is None:
        print(f"[diff] {label}: every stage of every layer is equal, bit for "
              "bit", flush=True)
    else:
        print(f"[diff] {label}: FIRST DIFFERING STAGE layer {first[0]} "
              f"{first[1]}: max|d| {first[2]:.6g}, {first[3]} elements, "
              f"{first[4]} bits", flush=True)
    return first


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--prompt", type=int, default=0,
                    help="index into chip_smoke.serve_traffic()")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (a rehearsal of the tool)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    import torch
    from chip_smoke import contraction_fan_in, serve_traffic
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import ExecOptions
    card = f"{args.device or 'cuda'}: no nvidia-smi"
    if shutil.which("nvidia-smi"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    print(card)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg, device=args.device)
    # the monolithic engine's MoE groups are the chunk's rows
    model_m = build_model(cfg, ExecOptions(moe_group=64), device=args.device) \
        if cfg.family == "moe" else model
    params = contraction_fan_in(model.init(seed=0), cfg)
    prompt = serve_traffic()[1][args.prompt]
    prompt = np.asarray(prompt % cfg.vocab_size, np.int32)
    float_kv = ("bf16 weights, bf16 KV", dict(kv_dtype="bf16")) \
        if cfg.attn_kind == "mla" else ("bf16 weights, f32 KV", {})
    with torch.no_grad():
        for label, kw in (float_kv, ("int8 weights, int8 KV",
                                     dict(wdtype="int8", kv_dtype="int8"))):
            diff(model, model_m, params, prompt, cfg.n_layers, label, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
