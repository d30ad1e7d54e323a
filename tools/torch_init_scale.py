#!/usr/bin/env python3
"""Why the full-width logit check needs rescaled random weights.

    python tools/torch_init_scale.py      # needs a CUDA card

Serves three smollm-360m prompts (44, 161 and 704 tokens, 8 new tokens) at
full width in f32 through the port's engine twice: once through the CUDA
attention kernels and once through their plain PyTorch versions (the same
math, summed in another order). It does so for the schema's own init and for
the init with `chip_smoke.contraction_fan_in`, and prints the std of q and k
at layer 0 and, per decode step, the largest logit difference

- between the two engines (kernels against plain versions), and
- between the plain engine and a cacheless teacher-forced pass of the same
  tokens (`transformer.forward_hidden`, no kernel on either side).

A chaotic random model shows O(1) differences in both; the second witness
involves none of the kernels.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import contraction_fan_in  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_paged_plain  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402


def engine_requests(model, params, prompts, *, plain: bool):
    saved = attention.decode_attention_cuda, attention.flash_attention_paged_cuda
    if plain:
        attention.decode_attention_cuda = decode_attention_plain
        attention.flash_attention_paged_cuda = flash_attention_paged_plain
    try:
        eng = ServeEngine(model, n_slots=8, max_len=1024, params=params,
                          page_size=32, keep_logits=True)
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_to_completion()
    finally:
        attention.decode_attention_cuda, attention.flash_attention_paged_cuda = saved
    return reqs


def teacher_forced(params, req, cfg):
    """Logits of each decode step of `req` from one cacheless pass over its
    prompt and emitted tokens."""
    plen, n = req.prompt.shape[0], len(req.out_tokens)
    toks = np.concatenate([req.prompt, np.asarray(req.out_tokens[:-1], np.int32)])
    with torch.no_grad():
        hidden, _ = transformer.forward_hidden(
            params, torch.as_tensor(toks, device="cuda")[None].int(), cfg,
            opts=transformer.ExecOptions(attn_impl="reference"))
        return transformer.lm_logits(params, hidden[:, plen - 1:plen - 1 + n],
                                     cfg)[0, :, :cfg.vocab_size].float().cpu()


def _steps(d):
    return [round(v, 4) for v in d.amax(-1).tolist()]


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cfg = get_config("smollm-360m")
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (44, 161, 704)]
    base = model.init(seed=0, dtype=torch.float32)
    for label, params in (("schema init", base),
                          ("contraction fan-in", contraction_fan_in(base, cfg))):
        x = transformer.embed_tokens(
            params, torch.as_tensor(prompts[0], device="cuda")[None], cfg)
        lp = transformer.layer_params(params["layers"], 0)
        h = transformer.rms_norm(x, lp["attn_norm"])
        q = torch.einsum("bsd,dhk->bshk", h, lp["wq"])
        k = torch.einsum("bsd,dhk->bshk", h, lp["wk"])
        kern = engine_requests(model, params, prompts, plain=False)
        plain = engine_requests(model, params, prompts, plain=True)
        print(f"{label}: layer-0 q std {q.std().item():.3f} k std "
              f"{k.std().item():.3f}")
        for p, a, b in zip(prompts, kern, plain):
            la, lb = torch.stack(a.logits), torch.stack(b.logits)
            tf = teacher_forced(params, b, cfg)
            print(f"  plen {p.shape[0]}: max |logit(kernels) - logit(plain)| "
                  f"per step {_steps((la - lb).abs())}")
            print(f"  plen {p.shape[0]}: max |logit(plain engine) - "
                  f"logit(teacher-forced)| per step {_steps((lb - tf).abs())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
