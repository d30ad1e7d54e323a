#!/usr/bin/env python3
"""How far a served moe model's logits lie from its cacheless replay, beside
how far the replay moves when only the order of its own sums changes, and
what a planted fault reads on the same comparison.

    python tools/torch_replay_noise.py [--arch deepseek-v2-lite] [--kv bf16]
    python tools/torch_replay_noise.py --smoke --device cpu   # a rehearsal

Serves chip_smoke.py's 44-, 230- and 658-token prompts (16 new tokens each)
one at a time on the paged chunked engine (full-width random weights,
`chip_smoke.contraction_fan_in` applied; 8 slots, page 32, chunk 64, the
prefix cache off) with the KV storage `--kv`, recording the router's
choices, and replays prompt + tokens without a cache, grouped and routed
as the engine did (`serve/moe_replay.py`, the reference attention). The
engine computes the prompt's last position twice: in its prefill chunk,
whose K/V row every later step reads, and in the first decode step, which
gives step 0's logits. The exact replay (`engine_replay`, the one
`chip_smoke.check_moe_teacher_forced` reads) takes each version where the
engine does; the one-pass replay takes the decode's version for both.
For a dense model (`--arch smollm-360m|gemma-7b|chatglm3-6b`) it prints
the reading of chip_smoke's teacher-forced check on the same prompts (the
paged chunked engine against the cacheless pass with the reference
attention), the pass's own noise under a one-block softmax and the logits'
std. For a moe model it prints:
- the expert assignments of the last prompt row that its chunk's capacity
  dropped, by layer (the decode's version drops none);
- the engine's gap to each replay, at step 0 and over steps 1 on;
- the replay's own noise: the one-pass replay with its attention's
  softmax computed as one online-softmax block (`chunked_attention`)
  instead of the reference softmax, the same math in another f32 order;
- the largest router-logit gap between engine and exact replay at each
  layer, on the decode rows;
- with `--faults` (MLA only), the check's reading for an engine with a
  planted fault (`chip_smoke.planted`, at the attention dispatchers, so the
  kernels take it too): `fp8-latent`, latent rows read through e5m2 (a pool
  of lower precision than configured); `short-key`, a decode step that
  misses its newest key. `chip_smoke.py` runs them as negative controls.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

PROMPTS = (7, 3, 0)       # chip_smoke.serve_traffic(): 44, 230, 658 tokens
NEW_TOKENS = 16


def chunk_drops(rec, cfg, plen, chunk, group):
    """Per layer, how many of position plen - 1's expert assignments its
    prefill chunk dropped (`moe.make_dispatch` at the chunk's capacity)."""
    import torch
    from repro_torch.models import moe
    L, k = cfg.n_layers, cfg.moe_top_k
    j, r = divmod(plen - 1, chunk)
    chunks = [b for b in range(len(rec) // L)
              if rec[b * L][1].shape[0] == chunk]
    gs = min(group, chunk)
    cap = moe.capacity(cfg, gs)
    out = []
    for layer in range(L):
        idx = rec[chunks[j] * L + layer][1].reshape(chunk // gs, gs, k)
        dispatch, _ = moe.make_dispatch(torch.ones(idx.shape), idx,
                                        cfg.n_experts, cap)
        out.append(k - int(dispatch[r // gs, r % gs].sum()))
    return out


def dense_noise(cfg, model, params, kw, one_block):
    """A dense model's reading of chip_smoke's teacher-forced check (the
    engine against `chip_smoke.teacher_forced_logits`, the reference
    attention) beside the same pass's own noise when only its attention
    sums change order (one online-softmax block), and the logits' std."""
    import torch
    from chip_smoke import _engine, serve_traffic, teacher_forced_logits
    from repro_torch.models import attention as attn_mod
    reference = attn_mod.reference_attention
    _, prompts = serve_traffic()
    for i in PROMPTS:
        prompt = np.asarray(prompts[i] % cfg.vocab_size, np.int32)
        eng = _engine(model, params, True, prefix_cache=False, **kw)
        r = eng.submit(prompt, max_new_tokens=NEW_TOKENS)
        eng.run_to_completion()
        got = torch.stack(r.logits)[:, :cfg.vocab_size]
        ref = teacher_forced_logits(eng, prompt, r.out_tokens)
        attn_mod.reference_attention = one_block
        try:
            twin = teacher_forced_logits(eng, prompt, r.out_tokens)
        finally:
            attn_mod.reference_attention = reference
        print(f"{cfg.name} plen={prompt.shape[0]}: engine vs the teacher-"
              f"forced pass {(got - ref).abs().max().item():.4f}; the pass vs "
              f"its one-block-softmax twin {(ref - twin).abs().max().item():.4f}"
              f"; logit std {ref.std().item():.3f}", flush=True)
        del eng
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v2-lite",
                    choices=["deepseek-v2-lite", "qwen2-moe-a2.7b",
                             "smollm-360m", "gemma-7b", "chatglm3-6b"])
    ap.add_argument("--kv", default="bf16", choices=["f32", "bf16", "int8"],
                    help="KV storage (int8 also takes int8 weights)")
    ap.add_argument("--faults", action="store_true",
                    help="also read the planted faults (MLA only)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (a rehearsal of the tool)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    import torch
    from chip_smoke import (
        FAULTS, _engine, contraction_fan_in, planted, serve_traffic)
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer
    from repro_torch.models.registry import build_model
    from repro_torch.serve.moe_replay import (
        engine_replay, engine_routes, moe_teacher_forced_segments,
        recorded_routes, teacher_forced_pass)
    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()[0])
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.faults and cfg.attn_kind != "mla":
        ap.error("--faults plants them in the latent-row attention: MLA "
                 "only")
    model = build_model(cfg, device=args.device)
    params = contraction_fan_in(model.init(seed=0), cfg)
    kw = {"f32": {}, "bf16": dict(kv_dtype="bf16"),
          "int8": dict(wdtype="int8", kv_dtype="int8")}[args.kv]
    reference = attn_mod.reference_attention

    def one_block(q, k, v, *, causal=True, window=0, scale=None, **_):
        s = q.shape[1]
        return attn_mod.chunked_attention(q, k, v, causal=causal,
                                          window=window, scale=scale,
                                          q_chunk=s, kv_chunk=s)

    if cfg.family == "dense":
        return dense_noise(cfg, model, params, kw, one_block)

    def serve(prompt, fault=None):
        eng = _engine(model, params, True, prefix_cache=False, **kw)
        with recorded_routes() as rec, planted(fault):
            r = eng.submit(prompt, max_new_tokens=NEW_TOKENS)
            eng.run_to_completion()
        return eng, rec, torch.stack(r.logits)[:, :cfg.vocab_size], r

    def one_pass(eng, rec, toks, plen, n, attn=reference):
        """The single pass of the default grouping (the decode's version
        of the prompt's last row), under `attn`."""
        C = eng.chunk_tokens
        idx, _ = engine_routes(rec, cfg.n_layers, plen, n, C, eng.n_slots)
        attn_mod.reference_attention = attn
        try:
            hidden, _ = teacher_forced_pass(
                eng.params, toks, cfg, moe_teacher_forced_segments(plen, n, C),
                kv_round=kv_round(eng), forced=idx.to(eng.device))
        finally:
            attn_mod.reference_attention = reference
        return logits_of(eng, hidden[:, plen - 1:])

    def exact(eng, rec, toks, plen, n):
        hidden, seen, routes = engine_replay(
            eng.params, toks, cfg, plen, n, eng.chunk_tokens,
            kv_round=kv_round(eng), rec=rec, n_slots=eng.n_slots)
        return logits_of(eng, hidden), seen, routes

    def kv_round(eng):
        return None if eng.kv_dtype == torch.float32 else eng.kv_dtype

    def logits_of(eng, hidden):
        return transformer.lm_logits(
            eng.params, hidden, cfg)[0, :, :cfg.vocab_size].float().cpu()

    def gaps(got, ref):
        d = (got - ref).abs().max(-1).values
        return d[0].item(), d[1:].max().item()

    _, prompts = serve_traffic()
    for i in PROMPTS:
        prompt = np.asarray(prompts[i] % cfg.vocab_size, np.int32)
        for fault in (None,) + (FAULTS if args.faults else ()):
            eng, rec, got, r = serve(prompt, fault)
            plen, n = prompt.shape[0], len(r.out_tokens)
            toks = torch.as_tensor(np.concatenate(
                [prompt, np.asarray(r.out_tokens[:-1], np.int32)]),
                device=eng.device).int()
            with torch.no_grad():
                ref, seen, (_, z_e) = exact(eng, rec, toks, plen, n)
                e0, e1 = gaps(got, ref)
                if fault:
                    print(f"  planted {fault}: check reading "
                          f"{max(e0, e1):.4f} (step 0 {e0:.4f}, steps 1+ "
                          f"{e1:.4f})", flush=True)
                    del eng
                    continue
                single = one_pass(eng, rec, toks, plen, n)
                twin = one_pass(eng, rec, toks, plen, n, one_block)
            drops = chunk_drops(rec, cfg, plen, eng.chunk_tokens,
                                model.cfg.moe_group)
            b0, b1 = gaps(got, single)
            dz = [(z.float().cpu()[plen:] - z_e[layer][plen:]).abs().max()
                  .item() for layer, (_, z, _) in enumerate(seen)]
            print(f"{cfg.name} kv {args.kv} plen={plen}: last prompt row's "
                  f"assignments dropped in its chunk, by layer {drops}")
            print(f"  engine vs the exact replay (check reading "
                  f"{max(e0, e1):.4f}): step 0 {e0:.4f}, steps 1+ "
                  f"{e1:.4f}; vs the one-pass replay: step 0 {b0:.4f}, "
                  f"steps 1+ {b1:.4f}; one-pass replay vs its one-block-"
                  f"softmax twin {(single - twin).abs().max().item():.4f}; "
                  f"logit std {ref.std().item():.3f}")
            print(f"  router |dz| vs the exact replay, decode rows, by "
                  f"layer: {[round(x, 4) for x in dz]}", flush=True)
            del eng
    return 0


if __name__ == "__main__":
    sys.exit(main())
