"""Mamba-2 SSD blocks, the ssm family (port of `repro/models/ssm.py`).

Chunked SSD: within a chunk of `cfg.ssm_chunk` positions the recurrence is
a masked, decay-weighted quadratic; across chunks the state h (B, H, P, N)
carries in f32. The JAX package asserts S % chunk == 0 (a prompt longer
than a chunk and not a multiple of it raises there); here the whole chunks
come first and one last chunk of S mod chunk rows follows, with the same
algebra, so at every length the reference accepts both packages run the
same chunks.

Shapes: x (B, S, H, P) with H = d_inner / ssm_head_dim heads; the B and C
projections are shared across heads (one group), state size N. Decode is
one O(1) state update a token. Its state products are broadcast multiplies
with sums over a fixed axis, and every projection goes through `qeinsum`,
so a sequence's decode row does not depend on the batch beside it.

The cache is {'h': (L, B, H, P, N) f32, 'conv': {'x', 'b', 'c'}: (L, B,
K-1, C), 'pos': (B,)}; its size does not depend on max_len. Decode writes
it in place and returns the same dict with 'pos' advanced.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamDef, causal_conv1d, rms_norm
from repro_torch.models.quantized import decode_products, qeinsum
from repro_torch.models.transformer import (
    chunked_ce_loss, embed_tokens, layer_params, layer_views, lm_head_weights,
    lm_logits, _remat)


def schema(cfg) -> Dict[str, Any]:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    L, v, k = cfg.n_layers, cfg.padded_vocab, cfg.conv_kernel
    layers = {
        "norm": ParamDef((L, d), ("layers", None), init="ones"),
        "in_z": ParamDef((L, d, di), ("layers", "embed", "ff")),
        "in_x": ParamDef((L, d, di), ("layers", "embed", "ff")),
        "in_b": ParamDef((L, d, n), ("layers", "embed", None)),
        "in_c": ParamDef((L, d, n), ("layers", "embed", None)),
        "in_dt": ParamDef((L, d, h), ("layers", "embed", "heads")),
        "conv_x": ParamDef((L, k, di), ("layers", None, "ff"), init="small_normal"),
        "conv_b": ParamDef((L, k, n), ("layers", None, None), init="small_normal"),
        "conv_c": ParamDef((L, k, n), ("layers", None, None), init="small_normal"),
        "dt_bias": ParamDef((L, h), ("layers", "heads"), init="zeros"),
        "a_log": ParamDef((L, h), ("layers", "heads"), init="zeros"),
        "skip_d": ParamDef((L, h), ("layers", "heads"), init="ones"),
        "gate_norm": ParamDef((L, di), ("layers", "ff"), init="ones"),
        "out": ParamDef((L, di, d), ("layers", "ff", "embed")),
    }
    sch = {
        "embed": ParamDef((v, d), ("vocab", "embed"), init="small_normal"),
        "final_norm": ParamDef((d,), (None,), init="ones"),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        sch["lm_head"] = ParamDef((v, d), ("vocab", "embed"), init="small_normal")
    return sch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as `jax.nn.softplus` computes it (no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssd_chunk(xk, bk, ck, dk, af, hprev):
    """One chunk of T rows: (y (B,T,H,P) f32, h after the chunk)."""
    t = xk.shape[1]
    dkf = dk.float()
    xf, bf, cf = xk.float(), bk.float(), ck.float()
    lcum = torch.cumsum(dkf * af, dim=1)                  # inclusive (B,T,H)
    # intra-chunk: att[i,j] = C_i·B_j · exp(lcum_i - lcum_j) · dt_j, i >= j;
    # the decay is masked before exp, so no inf reaches a gradient
    scores = torch.einsum("bin,bjn->bij", cf, bf)
    decay = lcum[:, :, None, :] - lcum[:, None, :, :]     # (B,T,T,H)
    causal = torch.ones((t, t), dtype=torch.bool, device=xk.device).tril()
    w = torch.exp(torch.where(causal[None, :, :, None], decay,
                              float("-inf")))
    att = scores[:, :, :, None] * w * dkf[:, None, :, :]
    y = torch.einsum("bijh,bjhp->bihp", att, xf)
    # inter-chunk: the carried state's contribution
    y = y + torch.einsum("bin,bhpn->bihp", cf, hprev) \
        * torch.exp(lcum)[:, :, :, None]
    # h_new = exp(l_T)·h_prev + Σ_j exp(l_T - l_j)·dt_j·B_j ⊗ x_j
    ltot = lcum[:, -1:, :]                                 # (B,1,H)
    wj = torch.exp(ltot - lcum) * dkf                      # (B,T,H)
    s_chunk = torch.einsum("bjn,bjh,bjhp->bhpn", bf, wj, xf)
    hnew = torch.exp(ltot[:, 0, :])[:, :, None, None] * hprev + s_chunk
    return y, hnew


def _ssd_chunked(xh, bt, ct, dt, a, chunk: int,
                 h0: Optional[torch.Tensor] = None):
    """Chunk-parallel SSD over any S: chunks of t = min(chunk, S) rows, the
    last one S mod t rows when t does not divide S.

    xh: (B,S,H,P); bt/ct: (B,S,N); dt: (B,S,H) (post-softplus); a: (H,) < 0;
    h0: initial state (B,H,P,N) or None. Returns (y (B,S,H,P) in xh's
    dtype, h_final f32)."""
    b, s, h, p = xh.shape
    n = bt.shape[-1]
    t = min(chunk, s)
    af = a.float()
    hprev = torch.zeros((b, h, p, n), dtype=torch.float32,
                        device=xh.device) if h0 is None else h0
    ys = []
    for c0 in range(0, s, t):
        sl = slice(c0, c0 + t)
        y, hprev = _ssd_chunk(xh[:, sl], bt[:, sl], ct[:, sl], dt[:, sl],
                              af, hprev)
        ys.append(y.to(xh.dtype))
    return torch.cat(ys, dim=1), hprev


def _layer_inputs(x, lp, cfg, conv_state=None):
    """Projections + causal conv + activations for one layer."""
    z = qeinsum("bsd,de->bse", x, lp["in_z"])
    xi = qeinsum("bsd,de->bse", x, lp["in_x"])
    bt = qeinsum("bsd,dn->bsn", x, lp["in_b"])
    ct = qeinsum("bsd,dn->bsn", x, lp["in_c"])
    dt_raw = qeinsum("bsd,dh->bsh", x, lp["in_dt"])
    cs = {} if conv_state is None else conv_state
    xi, cs_x = causal_conv1d(xi, lp["conv_x"], state=cs.get("x"))
    bt, cs_b = causal_conv1d(bt, lp["conv_b"], state=cs.get("b"))
    ct, cs_c = causal_conv1d(ct, lp["conv_c"], state=cs.get("c"))
    xi, bt, ct = F.silu(xi), F.silu(bt), F.silu(ct)
    dt = softplus(dt_raw.float() + lp["dt_bias"].float())
    return z, xi, bt, ct, dt, {"x": cs_x, "b": cs_b, "c": cs_c}


def _finish(y, z, xi, lp, cfg):
    """Skip connection + gated RMSNorm + out projection."""
    b, s, _ = z.shape
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    y = y + xi.reshape(b, s, h, p) \
        * lp["skip_d"][None, None, :, None].to(y.dtype)
    y = y.reshape(b, s, h * p)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), lp["gate_norm"])
    return qeinsum("bse,ed->bsd", y, lp["out"])


def layer_full(x, lp, cfg):
    """Full-sequence SSD layer (train / prefill). Returns (out, state)."""
    b, s, _ = x.shape
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    xn = rms_norm(x, lp["norm"])
    z, xi, bt, ct, dt, conv_state = _layer_inputs(xn, lp, cfg)
    a = -torch.exp(lp["a_log"].float())
    y, hf = _ssd_chunked(xi.reshape(b, s, h, p), bt, ct, dt, a,
                         cfg.ssm_chunk)
    return x + _finish(y, z, xi, lp, cfg), {"h": hf, "conv": conv_state}


def layer_decode(x, lp, cfg, state):
    """Single-step recurrence. x: (B,1,d); state {'h': (B,H,P,N),
    'conv': {...}}. The state products ("bn,bh,bhp->bhpn" and
    "bn,bhpn->bhp" in the JAX package) are broadcast products and a sum
    over N, never a library product picked by the batch size."""
    b = x.shape[0]
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    xn = rms_norm(x, lp["norm"])
    z, xi, bt, ct, dt, conv_state = _layer_inputs(xn, lp, cfg, state["conv"])
    a = -torch.exp(lp["a_log"].float())
    xh = xi.reshape(b, h, p).float()
    dt0 = dt[:, 0, :]                                     # (B,H)
    decay = torch.exp(dt0 * a)
    upd = (dt0[:, :, None] * xh)[:, :, :, None] \
        * bt[:, 0].float()[:, None, None, :]              # (B,H,P,N)
    hnew = decay[:, :, None, None] * state["h"] + upd
    y = torch.sum(ct[:, 0].float()[:, None, None, :] * hnew, dim=-1)
    y = y[:, None].to(x.dtype)                            # (B,1,H,P)
    return x + _finish(y, z, xi, lp, cfg), {"h": hnew, "conv": conv_state}


# ---------------------------------------------------------------------------
# Model entry points (same contract as transformer.py)
# ---------------------------------------------------------------------------

def _forward_full(params, tokens, cfg, *, mode: str, remat: str = "none"):
    """(final-normed hidden, per-layer states stacked on axis 0 in
    'prefill' mode, None in 'train' mode)."""
    x = embed_tokens(params, tokens, cfg)
    if mode == "train":
        layer = _remat(lambda x, lp: layer_full(x, lp, cfg)[0], remat)
        for lp in layer_views(params["layers"]):
            x = layer(x, lp)
        return rms_norm(x, params["final_norm"]), None
    if mode != "prefill":
        raise ValueError(f"ssm forward mode {mode!r}")
    hs, convs = [], {"x": [], "b": [], "c": []}
    for i in range(cfg.n_layers):
        x, st = layer_full(x, layer_params(params["layers"], i), cfg)
        hs.append(st["h"])
        for key in convs:
            convs[key].append(st["conv"][key])
    states = {"h": torch.stack(hs),
              "conv": {key: torch.stack(v) for key, v in convs.items()}}
    return rms_norm(x, params["final_norm"]), states


def train_loss(params, batch, cfg, *, ce_chunk: int = 512,
               remat: str = "none", opts=None):
    """(mean next-token CE, {"loss": it}) of batch {'tokens','labels'}."""
    del opts
    hidden, _ = _forward_full(params, batch["tokens"], cfg, mode="train",
                              remat=remat)
    loss = chunked_ce_loss(hidden, lm_head_weights(params, cfg),
                           batch["labels"], cfg, ce_chunk=ce_chunk,
                           remat=remat)
    return loss, {"loss": loss}


def prefill(params, batch, cfg, opts=None):
    """Exact-length prefill: (last-position logits (B,1,V) f32, cache)."""
    del opts
    tokens = batch["tokens"]
    hidden, states = _forward_full(params, tokens, cfg, mode="prefill")
    logits = lm_logits(params, hidden[:, -1:, :], cfg)
    b, s = tokens.shape
    return logits, dict(states, pos=torch.full(
        (b,), s, dtype=torch.int32, device=tokens.device))


def decode_step(params, batch, cache, cfg, opts=None):
    """One token step over batch {'tokens': (B,1)}: writes every layer's h
    and conv state in place; returns (logits (B,1,V) f32, cache) with
    cache['pos'] replaced by pos + 1. Its products are a decode step's
    (`quantized.decode_products`)."""
    del opts
    with decode_products():
        x = embed_tokens(params, batch["tokens"], cfg)
        conv = cache["conv"]
        for i in range(cfg.n_layers):
            st = {"h": cache["h"][i],
                  "conv": {key: conv[key][i] for key in conv}}
            x, new = layer_decode(x, layer_params(params["layers"], i), cfg,
                                  st)
            cache["h"][i] = new["h"]
            for key in conv:
                conv[key][i].copy_(new["conv"][key])
        x = rms_norm(x, params["final_norm"])
        logits = lm_logits(params, x, cfg)
    cache["pos"] = cache["pos"] + 1
    return logits, cache


def cache_shape(cfg, batch: int, max_len: int, dtype=torch.float32):
    """{name: (shape, dtype)}: the state is O(1) in the context length;
    max_len only bounds positions (no row of it is allocated)."""
    del max_len
    L, h, p, n = cfg.n_layers, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di, k = cfg.d_inner, cfg.conv_kernel
    return {
        "h": ((L, batch, h, p, n), torch.float32),
        "conv": {
            "x": ((L, batch, k - 1, di), dtype),
            "b": ((L, batch, k - 1, n), dtype),
            "c": ((L, batch, k - 1, n), dtype),
        },
        "pos": ((batch,), torch.int32),
    }
