"""Per-slot token sampling for the serving engine's decode step (port of
`repro/serve/sampling.py`).

Every slot carries its own (temperature, top_k, top_p) and PRNG stream as
(B,) tensors, so one batched sampler serves a decode batch that mixes
greedy and sampled requests, on the logits' device; only the (B,) tokens
leave it. The reference `vmap`s a per-row sampler; here every step is a
batched tensor op over the rows.

PRNG determinism: a slot's key for its i-th output token is
`fold_in(key(seed), i)` (`repro_torch.prng`, bit-equal to `jax.random`),
a pure function of the request's (seed, token index).

Greedy is the `temperature <= 0` path: those rows take `argmax` of the RAW
logits. One stable descending sort serves both filters: top-k keeps the
first k sorted positions (ties at the k-th value resolve by token id, as
`jnp.argsort`'s stable order), top-p keeps the smallest sorted prefix whose
softmax mass reaches p (the top token always survives). top_k = 0 and
top_p >= 1 disable their filters. Degenerate parameters clamp host-side
(`clamp_sample_params`): temperature < 0 and NaN are greedy, top_k >= vocab
is off, top_p = 0 is the argmax of the filtered, scaled distribution.
"""

from __future__ import annotations

import math

import torch

from repro_torch import prng
from repro_torch.models.attention import NEG_INF


def clamp_sample_params(temperature, top_k, top_p):
    """Host-side normalization of degenerate sampling params: negative or
    NaN temperature → 0 (greedy), negative top_k → 0 (off), top_p clipped
    into [0, 1] with NaN → 1 (off)."""
    temperature = float(temperature)
    top_p = float(top_p)
    if math.isnan(temperature):
        temperature = 0.0
    if math.isnan(top_p):
        top_p = 1.0
    return (max(0.0, temperature), max(0, int(top_k)),
            min(1.0, max(0.0, top_p)))


def clamp_rep_penalty(penalty) -> float:
    """A repetition penalty: 1.0 is the identity; NaN and non-positive
    values clamp to it. Values in (0, 1) reward repetition (HF)."""
    penalty = float(penalty)
    if math.isnan(penalty) or penalty <= 0.0:
        return 1.0
    return penalty


def apply_logit_processors(logits, rep_penalty, seen, bias):
    """logits (B, V) f32; rep_penalty (B,) f32; seen (B, V) bool (prompt
    and emitted tokens); bias (B, V) f32. Seen tokens' positive logits are
    divided by the penalty, negative ones multiplied (CTRL/HF); the bias
    is added after. Rows with penalty 1 and zero bias pass through."""
    pen = rep_penalty[:, None]
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen, penalized, logits) + bias


def filtered_logits(logits, temperature, top_k, top_p):
    """The sampler's rank space: (order, lt) where `order` (B, V) sorts each
    row descending (stable) and `lt` (B, V) holds the sorted logits with
    the top-k and top-p filters applied (NEG_INF) and divided by the
    temperature. The sampled token is order[b, argmax(gumbel + lt[b])]."""
    v = logits.shape[-1]
    order = torch.argsort(-logits, dim=-1, stable=True)
    ld = torch.gather(logits, -1, order)
    ranks = torch.arange(v, device=logits.device)[None, :]
    k = top_k[:, None]
    lk = torch.where((k > 0) & (ranks >= torch.clamp(k, 1, v)),
                     torch.full_like(ld, NEG_INF), ld)
    lt = lk / torch.clamp(temperature, min=1e-6)[:, None]
    probs = torch.softmax(lt, dim=-1)             # already descending
    keep = ((torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]) \
        | (ranks == 0)
    lt = torch.where((top_p[:, None] < 1.0) & ~keep,
                     torch.full_like(lt, NEG_INF), lt)
    return order, lt


def sample_tokens(logits, temperature, top_k, top_p, seed, counter):
    """Batched per-slot sampling. logits (B, V) f32; temperature, top_p
    (B,) f32; top_k, seed, counter (B,) integer — `counter` is the slot's
    output-token index. Returns (B,) int32 tokens."""
    greedy = torch.argmax(logits, dim=-1)
    order, lt = filtered_logits(logits, temperature, top_k, top_p)
    keys = prng.fold_in(prng.key(seed.to(torch.int64)), counter)
    rank = prng.categorical(keys, lt)
    sampled = torch.gather(order, -1, rank[:, None])[:, 0]
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)
