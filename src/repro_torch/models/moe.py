"""Mixture-of-Experts FFN (port of `repro/models/moe.py`): GShard grouped
dispatch with dense one-hot dispatch/combine tensors.

Tokens are cut into (G groups × group_size); each token's top-k experts are
assigned slots by a cumulative sum over the flattened (S·K) order of its
group, and a token past an expert's capacity is dropped (GShard,
arXiv:2006.16668). Every expert's slots are computed and dropped tokens give
zeros: the reference's semantics, kept as they are. The expert projections
go through `qeinsum`, so int8 expert weights run the port's expert-batched
`int8_matmul` (one launch for all experts) where the JAX package vmaps its
Pallas kernel.

`moe_ffn` is routing (`router_logits`, `router_topk`) then `moe_experts`;
a replay that routes tokens otherwise (`serve.moe_replay`) calls the two
halves itself.

Training differentiates the same functions: the gradient reaches the
router through the top-k gates in `combine`; the one-hot slots and their
cumulative-sum positions carry none, as in the reference. Multi-row groups
stay one a call in training too (the gradient is the sum over groups
either way). `load_balance_loss` is not wired into the loss, as in the
reference.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamDef, act_fn, glu_act
from repro_torch.models.quantized import qeinsum


def moe_schema(cfg, n_layers: int) -> dict:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    L = n_layers
    sch = {
        "router": ParamDef((L, d, e), ("layers", "embed", None), scale=0.1),
        "w1": ParamDef((L, e, d, fe), ("layers", "experts", "embed", "ff")),
        "w3": ParamDef((L, e, d, fe), ("layers", "experts", "embed", "ff")),
        "w2": ParamDef((L, e, fe, d), ("layers", "experts", "ff", "embed")),
    }
    if cfg.d_ff_shared:
        fs = cfg.d_ff_shared
        sch["shared_w1"] = ParamDef((L, d, fs), ("layers", "embed", "ff"))
        sch["shared_w3"] = ParamDef((L, d, fs), ("layers", "embed", "ff"))
        sch["shared_w2"] = ParamDef((L, fs, d), ("layers", "ff", "embed"))
        sch["shared_gate"] = ParamDef((L, d, 1), ("layers", "embed", None),
                                      scale=0.1)
    return sch


def capacity(cfg, group_size: int) -> int:
    c = int(group_size * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def router_topk(logits: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax → top-k → renormalized combine gates. logits: (..., E).

    Ties go to the lower expert index, as `jax.lax.top_k` breaks them:
    a stable descending sort (`torch.topk` promises no order among equal
    values, and bf16 router logits tie often)."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = top_p[..., :top_k], top_idx[..., :top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_idx


def make_dispatch(top_p, top_idx, n_experts: int, cap: int):
    """dispatch (G,S,E,C) 0/1 and combine (G,S,E,C) f32 tensors.

    top_p/top_idx: (G, S, K). Position-in-expert via cumulative sum over the
    flattened (S·K) assignment order (GShard §3.2); tokens past capacity
    drop."""
    g, s, k = top_idx.shape
    onehot = F.one_hot(top_idx.long(), n_experts).float()          # (G,S,K,E)
    flat = onehot.reshape(g, s * k, n_experts)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, s, k, n_experts)
    pos_sel = torch.sum(pos * onehot, dim=-1)                      # (G,S,K)
    within = pos_sel < cap
    dispatch = torch.zeros((g, s, n_experts, cap), dtype=torch.float32,
                           device=top_p.device)
    combine = torch.zeros_like(dispatch)
    for j in range(k):
        e_oh = onehot[:, :, j, :]                                  # (G,S,E)
        # one_hot has no out-of-range row (JAX gives zeros): clamp, then mask
        c_oh = F.one_hot(torch.clamp(pos_sel[:, :, j].long(), max=cap - 1),
                         cap).float() * within[:, :, j, None]
        outer = e_oh[..., :, None] * c_oh[..., None, :]
        dispatch = dispatch + outer
        combine = combine + outer * top_p[:, :, j, None, None].float()
    return dispatch, combine


def router_logits(xg: torch.Tensor, p: dict) -> torch.Tensor:
    """Grouped tokens (G, gs, d) → router logits (G, gs, E) in x's dtype."""
    return torch.einsum("gsd,de->gse", xg, p["router"].to(xg.dtype))


def moe_experts(xg: torch.Tensor, p: dict, cfg, top_p: torch.Tensor,
                top_idx: torch.Tensor) -> torch.Tensor:
    """Dispatch grouped tokens xg (G, gs, d) to their experts top_idx
    (G, gs, K) at capacity(gs), run the experts, combine with the gates
    top_p, and add the shared expert. Returns (G, gs, d)."""
    cap = capacity(cfg, xg.shape[1])
    act = act_fn(glu_act(cfg.activation))
    dispatch, combine = make_dispatch(top_p, top_idx, cfg.n_experts, cap)

    xin = torch.einsum("gsec,gsd->egcd", dispatch.to(xg.dtype), xg)
    h = act(qeinsum("egcd,edf->egcf", xin, p["w1"])) \
        * qeinsum("egcd,edf->egcf", xin, p["w3"])
    xout = qeinsum("egcf,efd->egcd", h, p["w2"])
    y = torch.einsum("gsec,egcd->gsd", combine,
                     xout.float()).to(xg.dtype)

    if "shared_w1" in p:            # shared expert (qwen2-moe), sigmoid-gated
        hs = act(qeinsum("gsd,df->gsf", xg, p["shared_w1"])) \
            * qeinsum("gsd,df->gsf", xg, p["shared_w3"])
        ys = qeinsum("gsf,fd->gsd", hs, p["shared_w2"])
        gate = torch.sigmoid(
            torch.einsum("gsd,do->gso", xg, p["shared_gate"]).float())
        y = y + (ys.float() * gate).to(xg.dtype)
    return y


def _moe_groups(xg: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    top_p, top_idx = router_topk(router_logits(xg, p), cfg.moe_top_k)
    return moe_experts(xg, p, cfg, top_p, top_idx)


def moe_ffn(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d). p holds this layer's slices of moe_schema.

    Groups of more than one row (prefill, training) are computed one group
    a call: a matrix product's row can round otherwise when the product
    has more rows (the library picks its kernel by shape), so a group of a
    monolithic prefill is then the same bits as the chunk of a chunked
    prefill that holds the same rows. Decode's one-row groups (a token of
    each slot) stay one call."""
    b, s, d = x.shape
    gs = min(cfg.moe_group, s)
    assert (b * s) % gs == 0, (b, s, gs)
    xg = x.reshape(b * s // gs, gs, d)
    if gs == 1 or xg.shape[0] == 1:
        return _moe_groups(xg, p, cfg).reshape(b, s, d)
    return torch.cat([_moe_groups(xg[i:i + 1], p, cfg)
                      for i in range(xg.shape[0])]).reshape(b, s, d)


def load_balance_loss(logits: torch.Tensor, top_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E · Σ_e f_e · p̄_e (for training integration)."""
    probs = torch.softmax(logits.float(), dim=-1)
    p_mean = torch.mean(probs.reshape(-1, n_experts), dim=0)
    counts = torch.mean(
        F.one_hot(top_idx.reshape(-1).long(), n_experts).float(), dim=0)
    return n_experts * torch.sum(p_mean * counts)
