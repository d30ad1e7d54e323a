#!/usr/bin/env python3
"""How far a served recurrent model's logits lie from chip_smoke.py's
cacheless teacher-forced pass, beside how far that pass moves when only
the order of its own sums changes, and what a planted fault reads on the
same comparison.

    python tools/torch_recurrent_noise.py [--arch recurrentgemma-2b]
    python tools/torch_recurrent_noise.py --smoke --device cpu  # a rehearsal

Serves three prompts of chip_smoke.py's phase 3h traffic (the 44- and
658-token ones and the model's own longest: 512 for mamba2-780m, 2600 for
recurrentgemma-2b; 16 new tokens each) on its 8-slot dense engine with
full-width random weights (bf16, `chip_smoke.contraction_fan_in`) keeping
every step's logits, and prints for each:
- the engine's gap to the teacher-forced pass (`chip_smoke.
  teacher_forced_logits`: the chunked SSD or the RG-LRU scan and the
  reference attention over prompt + tokens), the reading
  `chip_smoke.check_teacher_forced` compares with `tf_tol`;
- the pass's own noise: the same pass with its SSD or scan chunks of 128
  instead of 256 rows (the same recurrence summed in another order), and
  with every product as one call (`quantized.one_product`: cuBLAS picks
  its kernel by the row count) instead of 64-row blocks;
- the same engine and pass in f32 weights and activations (the hybrid's
  f32 prefill attention is the reference's: the prefill kernels take f32
  q up to head_dim 128), the algebra without bf16 rounding, and that
  pass's own noise under the chunk change;
- a planted fault on both comparisons (negative control): mamba2-780m
  keeps its SSD state in bf16 instead of f32 ("bf16-state");
  recurrentgemma-2b's decode misses the newest key of its ring
  ("short-key");
- the logits' std.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

NEW_TOKENS = 16


def serve(model, params, prompts, max_len, device, fault=None):
    """(tokens, (n, vocab) f32 logits) of each prompt on one 8-slot
    engine; `fault` plants a defect for the run."""
    import torch
    from repro_torch.models import rglru
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(model, n_slots=8, max_len=max_len, params=params,
                      keep_logits=True, device=device)
    if fault == "bf16-state":
        eng._cache["h"] = eng._cache["h"].to(torch.bfloat16)
    saved = rglru.attn_mod.decode_attention
    if fault == "short-key":
        rglru.attn_mod.decode_attention = \
            lambda q, k, v, n, **kw: saved(q, k, v, torch.clamp(n - 1, min=1),
                                           **kw)
    try:
        reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        eng.run_to_completion()
    finally:
        rglru.attn_mod.decode_attention = saved
    return eng, [(r.out_tokens, torch.stack(r.logits)) for r in reqs]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m",
                    choices=["mamba2-780m", "recurrentgemma-2b"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.quantized import one_product
    from repro_torch.models.registry import build_model
    spec = cs.MAMBA if args.arch == "mamba2-780m" else cs.RGEMMA
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    from repro_torch.models.transformer import ExecOptions
    # the CPU's blockwise attention takes no ragged S past 1024 (as the
    # JAX package's); the card's dense kernel takes any
    opts = ExecOptions(attn_impl="reference") if args.device == "cpu" \
        else None
    model = build_model(cfg, opts, device=args.device)
    device = model.device
    params = cs.contraction_fan_in(model.init(seed=0), cfg)
    lens, prompts, _ = cs.recurrent_traffic(dict(spec, vocab=cfg.vocab_size))
    picks = [lens.index(44), lens.index(658), len(lens) - 1]
    prompts = [prompts[i] for i in picks]
    if torch.cuda.is_available():
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    max_len = spec["max_len"]
    eng, runs = serve(model, params, prompts, max_len, device)
    f32 = {k: (v.float() if isinstance(v, torch.Tensor) else
               {kk: vv.float() for kk, vv in v.items()})
           for k, v in params.items()}
    model32 = build_model(cfg, ExecOptions(attn_impl="reference"),
                          device=device)
    eng32, runs32 = serve(model32, f32, prompts, max_len, device)
    fault = "bf16-state" if cfg.family == "ssm" else "short-key"
    _, faulty = serve(model, params, prompts, max_len, device, fault)
    _, faulty32 = serve(model32, f32, prompts, max_len, device, fault)

    def pass_(e, prompt, tokens, cfg_=None, one=False):
        view = e if cfg_ is None else types.SimpleNamespace(
            cfg=cfg_, kv_dtype=e.kv_dtype, device=e.device, params=e.params)
        if one:
            with one_product():
                return cs.teacher_forced_logits(view, prompt, tokens)
        return cs.teacher_forced_logits(view, prompt, tokens)

    half = dataclasses.replace(cfg, ssm_chunk=128)
    tol = cs.tf_tol(cfg)
    print(f"{cfg.name}: tf_tol {tol:.4f}; {NEW_TOKENS} new tokens a prompt")
    for prompt, (toks, got), (toks32, got32), (ftoks, fgot), (f32toks,
            f32got) in zip(prompts, runs, runs32, faulty, faulty32):
        ref = pass_(eng, prompt, toks)
        gap = (got - ref).abs().max().item()
        chunk = (pass_(eng, prompt, toks, half) - ref).abs().max().item()
        one = (pass_(eng, prompt, toks, one=True) - ref).abs().max().item()
        ref32 = pass_(eng32, prompt, toks32)
        g32 = (got32 - ref32).abs().max().item()
        c32 = (pass_(eng32, prompt, toks32, half) - ref32).abs().max().item()
        fgap = (fgot - pass_(eng, prompt, ftoks)).abs().max().item()
        f32gap = (f32got - pass_(eng32, prompt, f32toks)).abs().max().item()
        print(f"plen {prompt.shape[0]}: bf16: engine vs pass {gap:.4f}; the "
              f"pass's own noise: SSD/scan chunk 128 {chunk:.4f}, one-call "
              f"products {one:.4f}; planted {fault} {fgap:.4f}. f32: engine "
              f"vs pass {g32:.2e}, the pass's own noise {c32:.2e}, planted "
              f"{fault} {f32gap:.2e}; logit std {ref.std().item():.3f}",
              flush=True)


if __name__ == "__main__":
    main()
