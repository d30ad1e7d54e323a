"""Replay of a served moe-family request in one cacheless pass.

A chunked engine groups a request's MoE tokens by its schedule: the prompt
in chunk-row groups from position 0, and each decode step's rows a group
each. An expert's capacity, and so which tokens drop, depends on the group
(`moe.capacity`). `moe_teacher_forced_segments` gives that grouping for one
request served alone, and `teacher_forced_pass` runs prompt + generated
tokens through the model under it with the reference attention.

The pass can route every token to the experts the engine chose (`forced`,
read by `recorded_routes` and `engine_routes`). A near-tie between two
experts' router logits is then broken the same way in both runs, and the
pass's logits can be held to the engine's at every step; the pass also
returns its own choices, so the caller can judge each near-tie apart.
`engine_replay` puts two such passes together so that every step's logits
come from the rows the engine computed them from, the prompt's last row
included (the engine computes it twice).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe
from repro_torch.models import transformer
from repro_torch.models.common import rms_norm


def moe_teacher_forced_segments(plen: int, n_tokens: int, chunk: int,
                                last_in_chunk: bool = False
                                ) -> List[Tuple[int, int]]:
    """The row segments (n rows, group width) under which a cacheless pass
    over prompt + tokens[:-1] groups tokens as the chunked engine did for
    one request of `n_tokens` decode steps: prompt positions [0, plen - 1)
    in `chunk`-row groups from position 0 (the engine's last chunk also
    holds position plen - 1 and pad rows, both after the real rows in the
    slot order; the decode replays the former), then plen - 1 and each
    generated token but the last alone, as a decode step groups each
    sequence's row.

    The engine computes position plen - 1 twice: in its chunk, which
    writes the K/V row every later step reads, and in the first decode
    step, which gives the first token's logits and writes no row (ROADMAP
    C2). With `last_in_chunk` the pass takes the chunk's version: plen - 1
    stays in its chunk group, where the expert capacity can drop its
    assignments, and only the generated tokens follow alone. Such a pass
    gives the logits of steps 1 on; the default pass gives step 0's."""
    end = plen if last_in_chunk else plen - 1
    segs = [(min(chunk, end - s), chunk) for s in range(0, end, chunk)]
    rest = n_tokens - (end - (plen - 1))
    return segs + ([(rest, 1)] if rest else [])


@contextlib.contextmanager
def recorded_routes():
    """While the block runs, every `moe.router_topk` call's logits (as f32)
    and top-k experts, on the host, in call order."""
    rec = []
    orig = moe.router_topk

    def recording(logits, k):
        top_p, top_idx = orig(logits, k)
        rec.append((logits.float().cpu().reshape(-1, logits.shape[-1]),
                    top_idx.cpu().reshape(-1, k)))
        return top_p, top_idx
    moe.router_topk = recording
    try:
        yield rec
    finally:
        moe.router_topk = orig


def engine_routes(rec, n_layers: int, plen: int, n_tokens: int, chunk: int,
                  n_slots: int, last_in_chunk: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The experts (L, S, K) int64 and router logits (L, S, E) f32 at the
    S = plen - 1 + n_tokens positions of a request served alone in slot 0,
    from `recorded_routes` of its run: passes of n_layers router calls
    each, a prefill chunk (`chunk` rows from position chunk·j; its rows from
    plen - 1 on are left out, as the decode replays that position) or a
    decode step (one row per slot). `last_in_chunk` as in
    `moe_teacher_forced_segments`: position plen - 1 takes its chunk's
    route, and the first decode step's is left out."""
    end = plen if last_in_chunk else plen - 1
    if not rec or len(rec) % n_layers:
        raise ValueError(f"{len(rec)} router calls are not whole passes of "
                         f"{n_layers} layers")
    s = plen - 1 + n_tokens
    k, e = rec[0][1].shape[1], rec[0][0].shape[1]
    idx = torch.full((n_layers, s, k), -1, dtype=torch.long)
    logits = torch.zeros(n_layers, s, e)
    n_chunk = n_dec = 0
    for b in range(len(rec) // n_layers):
        blk = rec[b * n_layers:(b + 1) * n_layers]
        rows = blk[0][1].shape[0]
        if rows == chunk:
            lo = n_chunk * chunk
            n = max(0, min(chunk, end - lo))
            n_chunk += 1
        elif rows == n_slots and n_dec < n_tokens:
            lo, n = plen - 1 + n_dec, int(plen - 1 + n_dec >= end)
            n_dec += 1
        else:
            raise ValueError(f"a pass of {rows} router rows is neither a "
                             "chunk nor one of the request's decode steps")
        for layer, (lg, ix) in enumerate(blk):
            idx[layer, lo:lo + n] = ix[:n]
            logits[layer, lo:lo + n] = lg[:n]
    if bool((idx < 0).any()):
        raise ValueError("positions with no recorded route")
    return idx, logits


def routed_gates(logits: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
    """`moe.router_topk`'s combine gates for the experts top_idx: their
    softmax probabilities, renormalized."""
    top_p = torch.gather(torch.softmax(logits.float(), dim=-1), -1, top_idx)
    return top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)


def _moe_segments(h, p, cfg, segments, forced: Optional[torch.Tensor]):
    """MoE FFN of rows h (S, d), grouped segment by segment: (n, w > 1) is
    n rows of a w-row prefill chunk, padded with zero rows that take expert
    slots only after the real rows' (the flattened S·K order), so the real
    rows route and drop as beside the chunk's padding; (n, 1) is n decode
    rows, a group each. `forced` (S, K): route the real rows there.
    Returns (out (S, d), router logits (S, E), own experts (S, K))."""
    k, d = cfg.moe_top_k, h.shape[1]
    ys, zs, owns, at = [], [], [], 0
    for n, w in segments:
        rows = h[at:at + n]
        if w == 1:
            xg = rows[:, None]
        else:
            gs = min(cfg.moe_group, w)
            xg = torch.cat([rows, rows.new_zeros((w - n, d))]).reshape(
                w // gs, gs, d)
        z = moe.router_logits(xg, p)
        top_p, top_idx = moe.router_topk(z, k)
        zs.append(z.reshape(-1, z.shape[-1])[:n])
        owns.append(top_idx.reshape(-1, k)[:n])
        if forced is not None:
            flat = top_idx.reshape(-1, k).clone()
            flat[:n] = forced[at:at + n]
            top_idx = flat.reshape(top_idx.shape)
            top_p = routed_gates(z, top_idx)
        ys.append(moe.moe_experts(xg, p, cfg, top_p, top_idx)
                  .reshape(-1, d)[:n])
        at += n
    assert at == h.shape[0], (at, h.shape)
    return torch.cat(ys), torch.cat(zs), torch.cat(owns)


@contextlib.contextmanager
def _keys_below(n: int, device):
    """While the block runs, the reference attention reads keys [0, n)
    only: a row at n or after attends the rows before n, not itself."""
    orig = attn_mod.reference_attention
    kv_len = torch.tensor([n], device=device)

    def masked(q, k, v, **kw):
        return orig(q, k, v, kv_len=kv_len, **kw)
    attn_mod.reference_attention = masked
    try:
        yield
    finally:
        attn_mod.reference_attention = orig


def teacher_forced_pass(params, tokens: torch.Tensor, cfg, segments, *,
                        kv_round=None, forced: Optional[torch.Tensor] = None,
                        positions: Optional[torch.Tensor] = None):
    """One cacheless pass over tokens (S,) int: each layer as
    `transformer.layer_fn` in 'prefill' mode with the reference attention,
    its MoE FFN grouped by `segments` (`moe_teacher_forced_segments`).
    `forced` (L, S, K): route every token to these experts; None routes by
    the pass's own logits. `positions` (S,): the rows' positions (default
    0 .. S - 1). Returns (final-normed hidden (1, S, d), per layer (router
    input (S, d), router logits (S, E) in the input's dtype, the pass's own
    top-k experts (S, K)))."""
    if cfg.family != "moe":
        raise ValueError(f"family {cfg.family!r}: the replay groups MoE "
                         "tokens")
    opts = transformer.ExecOptions(attn_impl="reference")
    x = transformer.embed_tokens(params, tokens[None], cfg)
    if positions is None:
        positions = torch.arange(tokens.shape[0], device=tokens.device)
    positions = positions[None]
    seen = []
    for i in range(cfg.n_layers):
        lp = transformer.layer_params(params["layers"], i)
        a, _ = transformer.attn_block(
            rms_norm(x, lp["attn_norm"], plus_one=cfg.norm_plus_one), lp, cfg,
            positions=positions, mode="prefill", kv_round=kv_round, opts=opts)
        x = x + a
        h = rms_norm(x, lp["ffn_norm"], plus_one=cfg.norm_plus_one)[0]
        y, z, own = _moe_segments(h, lp, cfg, segments,
                                  None if forced is None else forced[i])
        x = x + y[None]
        seen.append((h, z, own))
    return rms_norm(x, params["final_norm"], plus_one=cfg.norm_plus_one), seen


def engine_replay(params, tokens: torch.Tensor, cfg, plen: int,
                  n_tokens: int, chunk: int, *, kv_round=None, rec=None,
                  n_slots: int = 0):
    """A paged chunked engine's run of one request served alone, replayed
    without a cache row for row as the engine computed it; tokens (S,) are
    the prompt and the generated tokens but the last.

    The engine computes position plen - 1 twice: in its last prompt chunk,
    which writes the K/V row every later step reads (the chunk's expert
    capacity can drop that row's assignments), and in the first decode
    step, whose query attends that row and writes none (ROADMAP C2). Pass
    A runs the tokens with plen - 1 in its chunk (`last_in_chunk`); its
    rows from plen on give steps 1 on. Pass C runs the prompt and then its
    last token again at position plen - 1, a decode row that attends the
    prompt's rows and not itself: step 0. With `rec` (`recorded_routes` of
    the run) every row takes the engine's experts, else its own.

    Returns (final-normed hidden (1, n_tokens, d) of the steps, per layer
    (router input, router logits, own experts) at pass A's S rows and then
    the decode row, and the engine's (experts, router logits) at the same
    rows, or None without `rec`)."""
    dev, L = tokens.device, cfg.n_layers
    routes = forced_a = forced_c = None
    if rec is not None:
        idx_a, z_a = engine_routes(rec, L, plen, n_tokens, chunk, n_slots,
                                   last_in_chunk=True)
        idx_b, z_b = engine_routes(rec, L, plen, n_tokens, chunk, n_slots)
        last = slice(plen - 1, plen)
        routes = (torch.cat([idx_a, idx_b[:, last]], 1),
                  torch.cat([z_a, z_b[:, last]], 1))
        forced_a = idx_a.to(dev)
        forced_c = torch.cat([idx_a[:, :plen], idx_b[:, last]], 1).to(dev)
    hid_a, seen_a = teacher_forced_pass(
        params, tokens, cfg,
        moe_teacher_forced_segments(plen, n_tokens, chunk, True),
        kv_round=kv_round, forced=forced_a)
    positions = torch.cat([torch.arange(plen), torch.tensor([plen - 1])])
    with _keys_below(plen, dev):
        hid_c, seen_c = teacher_forced_pass(
            params, torch.cat([tokens[:plen], tokens[plen - 1:plen]]), cfg,
            moe_teacher_forced_segments(plen, 1, chunk, True) + [(1, 1)],
            kv_round=kv_round, forced=forced_c, positions=positions.to(dev))
    seen = [tuple(torch.cat([a, c[plen:]]) for a, c in zip(sa, sc))
            for sa, sc in zip(seen_a, seen_c)]
    return torch.cat([hid_c[:, plen:], hid_a[:, plen:]], 1), seen, routes
