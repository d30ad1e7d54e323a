"""Port parity, MLA latent attention: `repro_torch.models.mla` and the
deepseek-v2-lite paths that reach it, against `repro/models/mla.py` and the
JAX engine, on deepseek-v2-lite `.smoke()` (2 layers, d_model 128, 4 heads,
kv_lora_rank 32, qk 32 nope + 16 rope, v_head_dim 32, 8 experts top-2; f32)
with JAX-initialised weights bridged to torch, and on the reduced
q_lora_rank 16 variant for the low-rank query branch.

Covered: the copied config and its `smoke()`; the schema in both query
branches; `mla_attn_block` in train, prefill, chunk and decode modes (dense
and paged caches, f32 and int8 latent pools) against JAX's, outputs and the
pool rows they write; `cache_shape` in every layout and storage dtype;
`quantize_params`' MLA leaves bit for bit and `qeinsum` on MLA's four
projection patterns; prefill and decode logits; the chunked engine against
the JAX engine; the reference's `test_chunked_mla_kv_dtypes` and
`test_mla_sampled_and_int8_weights`; `bench_serve`'s MLA pool values in
`BENCH_serve.json`; the serve CLI.

Tolerance: f32 `atol=rtol=1e-4` (the same math in another summation order,
as `tests/test_torch_model.py`); int8 pool rows within one quantization
step. Token streams equal the JAX engine's wherever the port's top-1
margin exceeds `MARGIN`."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jcfg
from repro.models import ExecOptions as JaxOpts, build_model as jbuild
from repro.models import mla as jmla
from repro.models.quantized import qeinsum as jqeinsum
from repro.models.quantized import quantize_kv_rows as jquant_rows
from repro.models.quantized import quantize_params as jquantize
from repro.models.transformer import cache_shape as jcache_shape
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import mla
from repro_torch.models.quantized import qeinsum, quantize_params
from repro_torch.models.registry import build_model
from repro_torch.models import transformer
from repro_torch.models.transformer import ExecOptions, alloc_cache
from repro_torch.serve.engine import ServeEngine, generate_greedy
from repro_torch.serve.moe_replay import (
    engine_replay, engine_routes, moe_teacher_forced_segments,
    recorded_routes, teacher_forced_pass)

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

ARCH = "deepseek-v2-lite"
TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3     # a top-1 margin below it is a near-tie either order breaks
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    if x is None:
        return None
    x = np.array(x, copy=True)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _prompt(seed, n, vocab=512):
    return np.asarray(
        jax.random.randint(jax.random.key(seed), (n,), 0, vocab), np.int32)


def _cfgs(q_lora):
    jc, tc = jcfg(ARCH).smoke(), get_config(ARCH).smoke()
    if q_lora:
        jc = dataclasses.replace(jc, q_lora_rank=q_lora)
        tc = dataclasses.replace(tc, q_lora_rank=q_lora)
    return jc, tc


def _pair(q_lora=0, key=1):
    jc, tc = _cfgs(q_lora)
    jm = jbuild(jc, JaxOpts(attn_impl="reference", ce_chunk=32))
    jp = jm.init(jax.random.key(key))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return tc, jm, jp, build_model(tc, device="cpu"), tp


@pytest.fixture(scope="module")
def mla_pair():
    return _pair()


@pytest.fixture(scope="module")
def mla_lora():
    return _pair(q_lora=16)


def _pairs(request, q_lora):
    return request.getfixturevalue("mla_lora" if q_lora else "mla_pair")


def _layer(params, i=0):
    return {k: v[i] for k, v in params["layers"].items()}


def test_config_matches_reference():
    """The copied config and its `smoke()` equal the reference field for
    field, and so do the MLA widths (latent 576 at full width: one row per
    token)."""
    for full in (True, False):
        want = jcfg(ARCH) if full else jcfg(ARCH).smoke()
        got = get_config(ARCH) if full else get_config(ARCH).smoke()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.mla_latent_dim, got.mla_qk_dim, got.mla_v_dim) == (
            want.mla_latent_dim, want.mla_qk_dim, want.mla_v_dim)
    full = get_config(ARCH)
    assert (full.mla_latent_dim, full.mla_qk_dim, full.mla_v_dim,
            full.n_heads_padded) == (576, 192, 128, 16)
    s = get_config(ARCH).smoke()
    assert (s.kv_lora_rank, s.qk_nope_dim, s.qk_rope_dim, s.v_head_dim,
            s.q_lora_rank) == (32, 32, 16, 32, 0)


@pytest.mark.parametrize("q_lora", [0, 16])
def test_schema_matches_jax(q_lora):
    jc, tc = _cfgs(q_lora)
    want = jmla.mla_schema(jc, 3)
    got = mla.mla_schema(tc, 3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k].shape, got[k].logical, got[k].init) == (
            want[k].shape, want[k].logical, want[k].init), k
    assert ("wq_a" in got) == bool(q_lora) and ("wq" in got) != bool(q_lora)


# ------------------------------------------------------- the attention block
B, S, PS, PPS = 2, 8, 8, 4           # batch, rows, page size, pages a slot


def _pool_case(cfg, kvd, paged, seed):
    """Random latent rows as a cache: paged (n_pages, ps, 1, r + p) with a
    shuffled table, or dense (B, PS * PPS, 1, r + p), in f32, bf16 or int8
    (`kvd`); int8 rows carry the reference quantizer's f16 scales."""
    w = cfg.mla_latent_dim
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * PPS
    rows = _np((n_pages, PS, 1, w), seed)
    table = (rng.permutation(n_pages - 1) + 1).reshape(B, PPS).astype(np.int32)
    if not paged:
        rows = rows[table].reshape(B, PPS * PS, 1, w)
    cache = {"k": rows}
    if kvd == "bf16":
        cache = {"k": np.asarray(jnp.asarray(rows, jnp.bfloat16))}
    if kvd == "int8":
        q, s = jquant_rows(jnp.asarray(rows))
        cache = {"k": np.asarray(q), "ks": np.asarray(s)}
    return cache, table


def _close_rows(got, want, kvd):
    if kvd == "int8":
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    elif kvd == "bf16":               # one bf16 ulp: 8 bits of mantissa
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), rtol=2.0 ** -8)
    else:
        np.testing.assert_allclose(got, want, **TOL)


MODES = ["train", "prefill", "chunk", "chunk-bf16", "chunk-int8",
         "decode-dense", "decode-paged-bf16", "decode-paged-int8"]


@pytest.mark.parametrize("q_lora", [0, 16])
@pytest.mark.parametrize("mode", MODES)
def test_mla_attn_block_matches_jax(request, mode, q_lora):
    """One layer's block, same inputs and weights: the output and every
    pool row it writes. Chunk mode streams rows [5, 13) of a slot whose
    earlier rows sit in the pool; decode writes row kv_len - 1 of each
    sequence and attends the rows before it."""
    cfg, jm, jp, tm, tp = _pairs(request, q_lora)
    jl, tl = _layer(jp), _layer(tp)
    jopts, topts = JaxOpts(attn_impl="reference"), ExecOptions(
        attn_impl="reference")
    base, kvd = mode.split("-")[0], mode.split("-")[-1]
    kvd = kvd if kvd in ("bf16", "int8") else None
    if base in ("train", "prefill"):
        x = _np((B, S, cfg.d_model), 3)
        pos = np.arange(S)[None, :]
        kw = dict(kv_round=jnp.bfloat16 if base == "prefill" else None)
        jo, jc = jmla.mla_attn_block(jnp.asarray(x), jl, cfg, jopts,
                                     positions=jnp.asarray(pos), mode=base,
                                     **kw)
        to, tc = mla.mla_attn_block(
            _t(x), tl, cfg, topts, positions=_t(pos), mode=base,
            kv_round=torch.bfloat16 if base == "prefill" else None)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        if base == "prefill":
            np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                       **TOL)
        else:
            assert tc is None and jc is None
        return
    if base == "chunk":
        cache, table = _pool_case(cfg, kvd, True, 5)
        start, n, C = 5, 8, 8
        x = _np((1, C, cfg.d_model), 6)
        pos = start + np.arange(C)[None, :]
        chunk = dict(start=np.asarray([start], np.int32),
                     length=np.asarray([n], np.int32), page_row=table[0])
        jo, jc = jmla.mla_attn_block(
            jnp.asarray(x), jl, cfg, jopts, positions=jnp.asarray(pos),
            mode="chunk", cache={k: jnp.asarray(v) for k, v in cache.items()},
            chunk={k: jnp.asarray(v) for k, v in chunk.items()})
        to, tc = mla.mla_attn_block(
            _t(x), tl, cfg, topts, positions=_t(pos), mode="chunk",
            cache={k: _t(v) for k, v in cache.items()},
            chunk={k: _t(v) for k, v in chunk.items()})
    else:
        paged = mode.startswith("decode-paged")
        cache, table = _pool_case(cfg, kvd, paged, 7)
        kv_len = np.asarray([9, 30], np.int32)
        x = _np((B, 1, cfg.d_model), 8)
        pos = (kv_len - 1)[:, None]
        jcache = {k: jnp.asarray(v) for k, v in cache.items()}
        tcache = {k: _t(v) for k, v in cache.items()}
        if paged:
            jcache["page_table"] = jnp.asarray(table)
            tcache["page_table"] = _t(table)
        jo, jc = jmla.mla_attn_block(jnp.asarray(x), jl, cfg, jopts,
                                     positions=jnp.asarray(pos),
                                     mode="decode", cache=jcache)
        to, tc = mla.mla_attn_block(_t(x), tl, cfg, topts, positions=_t(pos),
                                    mode="decode", cache=tcache)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert sorted(tc) == sorted(jc) == (["k", "ks"] if kvd == "int8"
                                        else ["k"])
    got = tc["k"].float() if kvd == "bf16" else tc["k"]
    _close_rows(got.numpy(), np.asarray(jc["k"]), kvd)
    if kvd == "int8":
        np.testing.assert_allclose(tc["ks"].numpy().astype(np.float32),
                                   np.asarray(jc["ks"]).astype(np.float32),
                                   rtol=1e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("paged", [False, True])
def test_cache_shape_matches_jax(paged, dtype):
    """One latent pool "k" of KV-head dim 1 and width r + p (int8 adds
    "ks"), the same keys, shapes and dtypes as JAX's `cache_shape`, at full
    width and at smoke size."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8,
           "fp8": jnp.float8_e5m2}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
           "fp8": torch.float8_e5m2}[dtype]
    kw = dict(page_size=32) if paged else {}
    for full in (True, False):
        jc = jcfg(ARCH) if full else jcfg(ARCH).smoke()
        tc = get_config(ARCH) if full else get_config(ARCH).smoke()
        want = jcache_shape(jc, 8, 1024, jdt, **kw)
        got = build_model(tc, device="cpu").cache_shape(8, 1024, tdt, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k][0]) == tuple(want[k].shape), k
            assert str(got[k][1]).split(".")[-1] == {
                "float8_e5m2": "float8_e5m2"}.get(
                    str(want[k].dtype), str(want[k].dtype)), k
    assert "v" not in got and got["k"][0][-2:] == (1, tc.mla_latent_dim)


# ------------------------------------------------------------- int8 weights
@pytest.mark.parametrize("q_lora", [0, 16])
def test_quantize_params_matches_jax(request, q_lora):
    """Every `_MLA_AXES` leaf quantized bit for bit as JAX's (int8 and
    scales); wk_b, wv_b, the norms and the router stay float and equal."""
    cfg, jm, jp, tm, tp = _pairs(request, q_lora)
    want = jax.tree.map(np.asarray, jquantize(jp, cfg))["layers"]
    got = quantize_params(tp, cfg)["layers"]
    assert sorted(got) == sorted(want)
    quantized = {k for k, v in got.items() if isinstance(v, dict)}
    assert quantized == ({"wq_a", "wq_b"} if q_lora else {"wq"}) | {
        "wkv_a", "wo", "w1", "w2", "w3", "shared_w1", "shared_w2",
        "shared_w3"}
    for k, v in want.items():
        if isinstance(v, dict):
            np.testing.assert_array_equal(got[k]["int8_q"].numpy(),
                                          v["int8_q"])
            np.testing.assert_array_equal(got[k]["s"].numpy(), v["s"])
        else:
            np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.parametrize("eq,xs,ws,axes", [
    ("bsd,dhk->bshk", (2, 3, 128), (128, 4, 48), (0,)),
    ("bsd,dr->bsr", (2, 3, 128), (128, 48), (0,)),
    ("bsr,rhk->bshk", (2, 3, 16), (16, 4, 48), (0,)),
    ("bshv,hvd->bsd", (2, 3, 4, 32), (4, 32, 128), (0, 1)),
])
def test_qeinsum_mla_patterns_match_jax(eq, xs, ws, axes):
    """MLA's four int8 projection patterns through the port's
    `int8_matmul` (its plain version on the CPU) against JAX's `qeinsum`
    on the same quantized leaf."""
    from repro.models.quantized import quantize_weight_channelwise
    x, w = _np(xs, 1), _np(ws, 2)
    leaf = jax.tree.map(np.asarray,
                        quantize_weight_channelwise(jnp.asarray(w), axes))
    want = np.asarray(jqeinsum(eq, jnp.asarray(x), leaf))
    got = qeinsum(eq, _t(x), {k: _t(v) for k, v in leaf.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("q_lora", [0, 16])
def test_prefill_logits_match_jax(request, q_lora):
    cfg, jm, jp, tm, tp = _pairs(request, q_lora)
    toks = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert sorted(tc) == ["k", "pos"]
    assert tuple(tc["k"].shape) == (cfg.n_layers, 2, 12, 1,
                                    cfg.mla_latent_dim)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_decode_logits_match_jax(mla_pair, kv_dtype):
    """One paged decode step from the same pool: logits, and the latent
    row written."""
    cfg, jm, jp, tm, tp = mla_pair
    jdt, tdt = ((jnp.float32, torch.float32) if kv_dtype == "f32"
                else (jnp.int8, torch.int8))
    jshapes = jm.cache_shape(2, 32, jdt, page_size=8)
    tcache = alloc_cache(tm.cache_shape(2, 32, tdt, page_size=8), "cpu")
    rng = np.random.default_rng(4)
    w = cfg.mla_latent_dim
    rows = _np((cfg.n_layers, 9, 8, 1, w), 5)
    if kv_dtype == "int8":
        q, s = jquant_rows(jnp.asarray(rows))
        pools = {"k": np.asarray(q), "ks": np.asarray(s)}
    else:
        pools = {"k": rows}
    table = (rng.permutation(8) + 1).reshape(2, 4).astype(np.int32)
    jcache = {k: jnp.zeros(v.shape, v.dtype) for k, v in jshapes.items()}
    for k, v in pools.items():
        jcache[k] = jnp.asarray(v)
        tcache[k].copy_(_t(v))
    pos = np.asarray([11, 26], np.int32)
    jcache.update(page_table=jnp.asarray(table), pos=jnp.asarray(pos))
    tcache["page_table"].copy_(_t(table))
    tcache["pos"].copy_(_t(pos))
    tok = np.asarray([[7], [300]], np.int32)
    jl, jc = jm.decode(jp, {"tokens": jnp.asarray(tok)}, jcache)
    tl, tc = tm.decode(tp, {"tokens": _t(tok)}, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_rows(tc["k"].numpy(), np.asarray(jc["k"]), kv_dtype == "int8")
    assert tc["pos"].tolist() == [12, 27]


def _hold_to(got_reqs, want_tokens):
    """The port's streams equal the JAX engine's up to a parting, and each
    parting is a near-tie in the port's kept logits (top-1 margin below
    MARGIN). Returns the count of identical streams."""
    same = 0
    for r, want in zip(got_reqs, want_tokens):
        assert len(r.out_tokens) == len(want)
        t = next((t for t, (a, b) in enumerate(zip(r.out_tokens, want))
                  if a != b), None)
        if t is None:
            same += 1
            continue
        top2 = torch.topk(r.logits[t], 2).values
        assert (top2[0] - top2[1]).item() < MARGIN, (r.rid, t)
    return same


@pytest.mark.parametrize("wdtype,kv_dtype", [(None, None), (None, "bf16"),
                                             ("int8", "int8")])
def test_engine_matches_jax_engine(mla_pair, wdtype, kv_dtype):
    """The paged chunked engine (page 8, 16-token chunks, 2 slots, three
    requests of 9, 17 and 23 tokens) emits the JAX engine's tokens; every
    request finishes and the pool balances. A bf16 latent pool is the
    served path on the card (`bench_serve`'s MLA pool dtype)."""
    cfg, jm, jp, tm, tp = mla_pair
    kw = dict(n_slots=2, max_len=64, page_size=8, wdtype=wdtype,
              kv_dtype=kv_dtype)
    prompts = [_prompt(n, n) for n in (9, 17, 23)]
    jeng = JaxEngine(jm, params=jp, **kw)
    jreqs = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    jeng.run_to_completion()
    eng = ServeEngine(tm, params=tp, device="cpu", keep_logits=True, **kw)
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run_to_completion()
    assert eng.chunked and all(r.done for r in reqs)
    assert _hold_to(reqs, [r.out_tokens for r in jreqs]) == len(prompts)
    eng.assert_accounting()
    assert eng.stats.pages_in_use == 0
    for name in ("prefill_chunks", "decode_compiles", "chunk_compiles"):
        assert getattr(eng.stats, name) == getattr(jeng.stats, name), name


def test_engine_replay_reads_the_chunks_last_row(mla_pair):
    """Twelve equal tokens route alike at layer 0, so the chunk's capacity
    (8) drops the prompt's last row there, and every later step reads that
    row's K/V as its chunk computed it (the first decode step, which
    computes the row again, writes none). `engine_replay` gives the
    engine's logits at every step; the one default pass, which takes the
    decode's version of the row, is off from step 1 on."""
    cfg, _, _, tm, tp = mla_pair
    eng = ServeEngine(tm, n_slots=2, max_len=64, params=tp, page_size=8,
                      keep_logits=True, device="cpu")
    plen, C = 12, eng.chunk_tokens
    prompt = np.full(plen, 7, np.int32)
    with recorded_routes() as rec:
        r = eng.submit(prompt, max_new_tokens=4)
        eng.run_to_completion()
    n = len(r.out_tokens)
    toks = torch.from_numpy(np.concatenate(
        [prompt, np.asarray(r.out_tokens[:-1], np.int32)]))
    got = torch.stack(r.logits)[:, :cfg.vocab_size]
    hidden, _, _ = engine_replay(tp, toks, cfg, plen, n, C, rec=rec,
                                 n_slots=eng.n_slots)
    exact = transformer.lm_logits(tp, hidden, cfg)[0, :, :cfg.vocab_size]
    idx, _ = engine_routes(rec, cfg.n_layers, plen, n, C, eng.n_slots)
    one, _ = teacher_forced_pass(tp, toks, cfg,
                                 moe_teacher_forced_segments(plen, n, C),
                                 forced=idx)
    one = transformer.lm_logits(tp, one[:, plen - 1:],
                                cfg)[0, :, :cfg.vocab_size]
    assert (got - exact).abs().max().item() <= 1e-4
    assert (got - one)[1:].abs().max().item() > 1e-3


# ---------------------------------------- the reference's own engine tests
@pytest.mark.parametrize("kv_dtype", [None, "bf16", "int8"])
def test_chunked_mla_kv_dtypes(mla_pair, kv_dtype):
    """`tests/test_chunked_prefill.py::test_chunked_mla_kv_dtypes` on the
    port: one latent pool, chunked engine == the dense oracle for f32,
    bf16 and int8 latent pools, across a chunk boundary (17 > 16)."""
    cfg, _, _, tm, tp = mla_pair
    assert cfg.attn_kind == "mla"
    for n in (9, 17):
        solo = generate_greedy(tm, tp, _prompt(n, n), n_tokens=4,
                               max_len=64, kv_dtype=kv_dtype)
        eng = ServeEngine(tm, n_slots=2, max_len=64, params=tp, page_size=8,
                          kv_dtype=kv_dtype, device="cpu")
        assert eng.chunked and "v" not in eng._cache
        r = eng.submit(_prompt(n, n), max_new_tokens=4)
        eng.run_to_completion()
        assert r.out_tokens == solo, (kv_dtype, n, r.out_tokens, solo)
        assert eng.stats.pages_in_use == 0
        assert eng.pages_allocatable() == eng.n_pages - 1


def test_mla_sampled_and_int8_weights(mla_pair):
    """`tests/test_chunked_prefill.py::test_mla_sampled_and_int8_weights`
    on the port: the paged sampled stream equals the dense engine's under
    the same seed, and int8 weights (`_MLA_AXES`) with an int8 latent pool
    stay token-exact against their own dense oracle."""
    cfg, _, _, tm, tp = mla_pair
    p = _prompt(23, 13)
    sp = dict(max_new_tokens=5, sample_params=(0.8, 5, 0.9), seed=7)
    eng_paged = ServeEngine(tm, n_slots=2, max_len=64, params=tp,
                            page_size=8, device="cpu")
    eng_dense = ServeEngine(tm, n_slots=2, max_len=64, params=tp,
                            paged=False, device="cpu")
    r_p, r_d = eng_paged.submit(p, **sp), eng_dense.submit(p, **sp)
    eng_paged.run_to_completion()
    eng_dense.run_to_completion()
    assert r_p.out_tokens == r_d.out_tokens
    solo = generate_greedy(tm, tp, p, n_tokens=4, max_len=64,
                           wdtype="int8", kv_dtype="int8")
    eng8 = ServeEngine(tm, n_slots=2, max_len=64, params=tp, page_size=8,
                       wdtype="int8", kv_dtype="int8", device="cpu")
    r8 = eng8.submit(p, max_new_tokens=4)
    eng8.run_to_completion()
    assert r8.out_tokens == solo


def test_bench_serve_mla_kv_bytes():
    """`bench_serve`'s MLA section (`benchmarks/run.py`): the bf16 latent
    pool against the same architecture flipped to GQA with an int8 pool, at
    identical page geometry. Bytes per token are pool math through the
    port's `kv_cache_bytes` and equal `BENCH_serve.json`'s deterministic
    values (the weights do not enter)."""
    mcfg = get_config(ARCH).smoke()
    gcfg = dataclasses.replace(mcfg, attn_kind="gqa")
    pool_kw = dict(n_slots=4, max_len=64, page_size=8, n_pages=33,
                   device="cpu")
    engs = {}
    for name, cfg, kvd in (("mla", mcfg, "bf16"), ("gqa", gcfg, "int8")):
        model = build_model(cfg, ExecOptions(moe_group=32), device="cpu")
        engs[name] = ServeEngine(model, params=model.init(0), kv_dtype=kvd,
                                 **pool_kw)
    rows = pool_kw["n_pages"] * pool_kw["page_size"]
    bpt_mla = engs["mla"].kv_cache_bytes() / rows
    bpt_gqa = engs["gqa"].kv_cache_bytes() / rows
    with open(os.path.join(REPO, "BENCH_serve.json")) as f:
        bench = json.load(f)
    assert bpt_mla == bench["mla_kv_bytes_per_token"]
    assert bpt_mla / bpt_gqa == bench["mla_vs_gqa_int8_kv_ratio"]
    assert bpt_mla < bpt_gqa


def test_serve_cli_smoke_on_cpu():
    """`--arch deepseek-v2-lite --smoke --device cpu` serves every request,
    int8 weights and latent pool included."""
    for extra in ([], ["--int8"]):
        stats = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                                "--requests", "3", "--slots", "2",
                                "--max-len", "64", "--new-tokens", "3",
                                "--page-size", "8", *extra])
        assert stats.tokens_out == 9 and stats.pages_in_use == 0
