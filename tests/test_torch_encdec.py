"""Port parity, the encdec family: seamless-m4t-medium `.smoke()` (2
encoder and 2 decoder layers, 4 heads of 32, GeGLU, cross_len 32) in f32
with the JAX package's weights, bridged, against `repro/models/encdec.py`
and the JAX engine.

The weights: the JAX package's init with every attention projection
rescaled to unit gain over its contraction fan-in (as `chip_smoke.py`
draws its models), both frameworks the same bits. At the schema's own
init the encoder's unmasked attention scores have a std near 32 (a
near-one-hot softmax over frames of unit scale), where f32 in any order
lands 2-3e-4 from an f64 evaluation of one layer (layer 0: the JAX
package 2.8e-4, the port 2.2e-4) and the error compounds from layer to
layer; rescaled, the comparison sees the arithmetic.

Model level: the bridged tree has the port's schema leaf for leaf (enc,
dec, enc_norm and the decoder's c* cross-attention leaves); `encode`,
`prefill_cross`'s ck/cv, prefill logits with every cache row, three
decode steps' logits and `train_loss` equal the JAX package's (f32, atol
= rtol = 1e-4: the same math in another summation order).

Engine level: six requests, each with frames of its own, decoder prompts
of 5 to 30 tokens across the smoke engines' 16-row chunk. Every layout
(dense, paged monolithic, paged chunked) emits the JAX engine's tokens in
the same layout with an f32 KV pool, and the JAX chunked engine's with
bf16 and int8 pools (the cross cache bf16 and f32) and with int8 weights.
Over a bf16 cache the JAX package's plain attention rounds the softmax
probabilities to bf16 before PV, where its Pallas decode kernel, and the
port's GQA attention and kernels, keep them f32
(`kernels.decode_attention.rounded_probs`). The bf16 case holds the
port's layouts to the JAX engine twice: with the plain path's rounding
patched in, token for token; and as shipped, under a margin gate (the
port's logits within LOGIT_TOL of the patched run's, and a stream may
part from the JAX engine's only at a near-tie). The reference cases hold
them to the port's own oracle.
The reference's own encdec cases (`test_chunked_families_exact`/
`_kv_matrix`, `test_paged_encdec_matches_oracle`,
`test_int8_engine_families_exact`) run on the port against its
`generate_greedy`. Dense attention over more keys than queries is
unmasked only: a causal call over two lengths raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model as jbuild
from repro.models import encdec as jenc
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.bridge import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tenc
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import alloc_cache
from repro_torch.serve.engine import ServeEngine, generate_greedy
from repro_torch.tree import tree_paths

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN, PAGE, SLOTS, NEW = 64, 8, 3, 4
LAYOUTS = {"dense": dict(paged=False, chunked_prefill=False),
           "paged": dict(paged=True, page_size=PAGE, chunked_prefill=False),
           "chunked": dict(paged=True, page_size=PAGE, chunked_prefill=True)}
COUNTERS = ("prefills", "prefill_tokens", "prefill_pad_tokens",
            "prefill_chunks", "decode_steps", "tokens_out",
            "peak_pages_in_use", "pages_in_use", "decode_compiles",
            "chunk_compiles")
PROMPT_LENS = (17, 5, 30, 9, 24, 13)
# bf16 KV as shipped against the JAX engine: rounding the probabilities to
# bf16 (the JAX plain path) or not (the port) moves this traffic's logits
# (std 0.23) by 3.3e-3 to 3.5e-3 in every layout; a step whose top-1 margin
# exceeds twice LOGIT_TOL must emit the JAX engine's token
LOGIT_TOL = 2 ** -7


def _fan_in(params, cfg):
    """The attention projections of both stacks (and the decoder's cross
    projections) at unit gain over their contraction fan-in: wq/wk/wv
    (d, heads, head_dim) from fan-in heads to d, wo (heads, head_dim, d)
    from head_dim to heads x head_dim."""
    gain = {"wq": cfg.n_heads / cfg.d_model, "wk": cfg.n_kv_heads / cfg.d_model,
            "wv": cfg.n_kv_heads / cfg.d_model, "wo": 1 / cfg.n_heads}
    gain.update({"c" + k: v for k, v in gain.items()})
    return dict(params, **{
        stack: {k: v * gain[k] ** 0.5 if k in gain else v
                for k, v in params[stack].items()}
        for stack in ("enc", "dec")})


@pytest.fixture(scope="module")
def case():
    cfg = get_config(ARCH).smoke()
    jm = jbuild(cfg)                     # default ExecOptions: chunked
    jp = _fan_in(jm.init(jax.random.key(0)), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, jp, build_model(cfg, device="cpu"), tp


def _frames(seed, cfg, b=None):
    shape = (cfg.cross_len, cfg.d_model) if b is None \
        else (b, cfg.cross_len, cfg.d_model)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _traffic(cfg):
    return [(_tokens(40 + i, n), {"frames": _frames(60 + i, cfg)})
            for i, n in enumerate(PROMPT_LENS)]


def _serve(eng, traffic):
    reqs = [eng.submit(p, max_new_tokens=NEW, extras=x) for p, x in traffic]
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def jax_tokens(case):
    """(layout, kv_dtype, wdtype) → the JAX engine's tokens and stats,
    each engine run once a module."""
    cfg, jm, jp, _, _ = case
    done = {}

    def run(layout, kv=None, wdtype=None):
        key = (layout, kv, wdtype)
        if key not in done:
            eng = JaxEngine(jm, params=jp, n_slots=SLOTS, max_len=MAX_LEN,
                            prefix_cache=False, kv_dtype=kv, wdtype=wdtype,
                            **LAYOUTS[layout])
            done[key] = (_serve(eng, _traffic(cfg)), eng.stats)
        return done[key]
    return run


def test_bridge_carries_the_encdec_tree(case):
    """The JAX tree, bridged, has the port's schema: enc, dec, enc_norm and
    the c* cross leaves with every path, shape and dtype of the port's own
    init."""
    cfg, _, _, tm, tp = case
    mine = tree_paths(tm.init(seed=0, dtype=torch.float32))
    got = tree_paths(tp)
    assert sorted(got) == sorted(mine)
    for path, leaf in mine.items():
        assert got[path].shape == leaf.shape and got[path].dtype == leaf.dtype
    assert {"enc", "dec", "enc_norm"} <= {p.split("/")[0] for p in got}
    assert {f"dec/{k}" for k in ("cwq", "cwk", "cwv", "cwo")} <= set(got)


def test_encode_and_prefill_cross(case):
    cfg, jm, jp, tm, tp = case
    frames = _frames(1, cfg, b=2)
    want = jenc.encode(jp, jnp.asarray(frames), cfg, jm.opts)
    got = tenc.encode(tp, torch.as_tensor(frames), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jc = jm.prefill_cross(jp, {"frames": jnp.asarray(frames)})
    tc = tm.prefill_cross(tp, {"frames": torch.as_tensor(frames)})
    for key in ("ck", "cv"):
        assert tc[key].shape == (cfg.n_dec_layers, 2, cfg.cross_len,
                                 cfg.kv_pad, cfg.head_dim)
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)


def test_prefill_then_decode_logits(case):
    """Prefill logits and every cache row, then three decode steps from a
    dense cache of MAX_LEN rows holding them."""
    cfg, jm, jp, tm, tp = case
    b, plen = 2, 11
    toks, frames = _tokens(2, (b, plen)), _frames(3, cfg, b=b)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "frames": jnp.asarray(frames)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks),
                             "frames": torch.as_tensor(frames)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v", "ck", "cv"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_shape(b, MAX_LEN, jnp.float32))
    tcache = alloc_cache(tm.cache_shape(b, MAX_LEN, torch.float32), "cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    for key in ("k", "v"):
        jcache[key] = jcache[key].at[:, :, :plen].set(jc[key])
        tcache[key][:, :, :plen] = tc[key]
    for key in ("ck", "cv"):
        jcache[key], tcache[key] = jc[key], tc[key].clone()
    jcache["pos"] = jnp.full((b,), plen, jnp.int32)
    tcache["pos"] = torch.full((b,), plen, dtype=torch.int32)
    for step in range(3):
        tok = _tokens(10 + step, (b, 1))
        jl, jcache = jm.decode(jp, {"tokens": jnp.asarray(tok)}, jcache)
        tl, tcache = tm.decode(tp, {"tokens": torch.as_tensor(tok)}, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["pos"].tolist() == [plen + 3] * b


def test_int8_tree_matches_jax(case):
    """`quantize_params` quantizes the leaves the JAX package's does
    (enc, dec), bit for bit, and `ModelApi.init_int8` equals it on the
    by-layer float draw."""
    from repro.models import quantized as jq
    from repro_torch.models import quantized as tq
    cfg, _, jp, tm, tp = case
    want = tree_paths(jax.tree.map(np.asarray, jq.quantize_params(jp, cfg)))
    got = tree_paths(tq.quantize_params(tp, cfg))
    assert sorted(got) == sorted(want)
    assert {p.split("/")[0] for p in got if p.endswith("int8_q")} == {"enc", "dec"}
    for path, leaf in want.items():
        assert got[path].numpy().tobytes() == leaf.tobytes(), path
    drawn = tree_paths(tm.init_int8(seed=3))
    direct = tree_paths(tq.quantize_params(tm.init(seed=3, by_layer=True), cfg))
    assert sorted(drawn) == sorted(direct)
    for path, leaf in direct.items():
        assert torch.equal(drawn[path], leaf), path


def test_train_loss(case):
    cfg, jm, jp, tm, tp = case
    toks = _tokens(4, (2, 32))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "frames": _frames(5, cfg, b=2)}
    jl, _ = jm.train_loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = tm.train_loss(tp, {k: torch.as_tensor(v)
                               for k, v in batch.items()}, ce_chunk=32)
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_matches_jax_engine(case, jax_tokens, layout):
    """f32 KV: the port's engine emits the JAX engine's tokens in the same
    layout, with its counters and its cache bytes (cross rows included)."""
    cfg, _, _, tm, tp = case
    want, jstats = jax_tokens(layout)
    eng = ServeEngine(tm, params=tp, device="cpu", n_slots=SLOTS,
                      max_len=MAX_LEN, prefix_cache=False, **LAYOUTS[layout])
    assert _serve(eng, _traffic(cfg)) == want
    for name in COUNTERS:
        assert getattr(eng.stats, name) == getattr(jstats, name), name
    if eng.paged:
        eng.assert_accounting()
        assert eng.pages_allocatable() == eng.n_pages - 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kv,wdtype", [("bf16", None), ("int8", None),
                                       ("int8", "int8")])
def test_lossy_layouts_match_jax_engine(case, jax_tokens, monkeypatch, layout,
                                       kv, wdtype):
    """bf16 (cross cache bf16, attended rounded in monolithic prefill) and
    int8 KV pools (cross cache f32), and int8 weights: every layout emits
    the JAX chunked engine's tokens (the reference's layouts agree with
    one another token for token). bf16: with the reference's rounding of
    the probabilities over a bf16 cache (module docstring)."""
    cfg, _, _, tm, tp = case
    want, _ = jax_tokens("chunked", kv, wdtype)
    if kv == "bf16":
        from repro_torch.kernels import decode_attention as dmod
        from repro_torch.kernels import flash_attention as fmod

        def reference_rounding(p, v, v_dim=None):
            return p.to(v.dtype).float() if v.dtype == torch.bfloat16 else p
        monkeypatch.setattr(dmod, "rounded_probs", reference_rounding)
        monkeypatch.setattr(fmod, "rounded_probs", reference_rounding)
    eng = ServeEngine(tm, params=tp, device="cpu", n_slots=SLOTS,
                      max_len=MAX_LEN, prefix_cache=False, kv_dtype=kv,
                      wdtype=wdtype, **LAYOUTS[layout])
    cross = eng._cache["ck"].dtype
    assert cross == (torch.bfloat16 if kv == "bf16" else torch.float32)
    assert _serve(eng, _traffic(cfg)) == want
    assert eng.stats.pages_in_use == 0


def _reference_rounding(p, v, v_dim=None):
    """The JAX plain path's probabilities over a bf16 cache."""
    return p.to(v.dtype).float() if v.dtype == torch.bfloat16 else p


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_bf16_kv_as_shipped_matches_jax_engine_at_margin(case, jax_tokens,
                                                         monkeypatch, layout):
    """bf16 KV with the port's f32 probabilities, unpatched: in every
    layout the logits of each decode step lie within LOGIT_TOL of the same
    engine's with the JAX plain path's rounding patched in (whose tokens
    are the JAX chunked engine's, above), and each stream emits the JAX
    engine's tokens, save that it may part from them at a step whose
    margin (patched logits, top-1 over the JAX token's runner-up) is at
    most 2 * LOGIT_TOL; the comparison of that request ends there."""
    cfg, _, _, tm, tp = case
    want, _ = jax_tokens("chunked", "bf16")

    def serve():
        eng = ServeEngine(tm, params=tp, device="cpu", n_slots=SLOTS,
                          max_len=MAX_LEN, prefix_cache=False,
                          kv_dtype="bf16", keep_logits=True,
                          **LAYOUTS[layout])
        reqs = [eng.submit(p, max_new_tokens=NEW, extras=x)
                for p, x in _traffic(cfg)]
        eng.run_to_completion()
        assert eng.stats.pages_in_use == 0
        return [(r.out_tokens, torch.stack(r.logits)) for r in reqs]

    shipped = serve()
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    monkeypatch.setattr(dmod, "rounded_probs", _reference_rounding)
    monkeypatch.setattr(fmod, "rounded_probs", _reference_rounding)
    patched = serve()
    for i, ((got, lg), (ref_toks, lr), jax_toks) in enumerate(
            zip(shipped, patched, want)):
        assert ref_toks == jax_toks, i
        for t, (a, b) in enumerate(zip(jax_toks, got)):
            # step t's logits follow the same tokens in both runs
            assert (lg[t] - lr[t]).abs().max().item() <= LOGIT_TOL, (i, t)
            if a != b:
                margin = (lr[t, a] - lr[t].topk(2).values[1]).item()
                assert margin <= 2 * LOGIT_TOL, (i, t, margin)
                break
        assert len(got) == len(jax_toks), i


@pytest.mark.parametrize("name,lengths,quant", [
    # test_chunked_prefill.py::test_chunked_families_exact / _kv_matrix
    ("chunked_exact", (9, 17), {}),
    ("chunked_kv_bf16", (17,), dict(kv_dtype="bf16")),
    ("chunked_kv_int8", (17,), dict(kv_dtype="int8")),
    # test_int8_decode.py::test_int8_engine_families_exact
    ("int8_exact", (7, 9), dict(wdtype="int8", kv_dtype="int8")),
])
def test_reference_family_cases(case, name, lengths, quant):
    """The reference's encdec cases on the port: the chunked (or int8)
    paged engine equals `generate_greedy` (the dense oracle, int8 where
    the engine is), frames from one seed for every prompt."""
    cfg, _, _, tm, tp = case
    extras = {"frames": _frames(9, cfg)}
    solo = {n: generate_greedy(tm, tp, _tokens(n, n), 3, max_len=MAX_LEN,
                               extras=extras, **quant) for n in lengths}
    eng = ServeEngine(tm, params=tp, device="cpu", n_slots=2,
                      max_len=MAX_LEN, page_size=PAGE, **quant)
    assert eng.chunked
    reqs = {n: eng.submit(_tokens(n, n), max_new_tokens=3, extras=extras)
            for n in lengths}
    eng.run_to_completion()
    for n, r in reqs.items():
        assert r.out_tokens == solo[n], (name, n, r.out_tokens, solo[n])
    assert eng.stats.pages_in_use == 0


def test_reference_paged_encdec_matches_oracle(case):
    """test_paged_kv.py::test_paged_encdec_matches_oracle: paged decoder
    self-attention K/V and dense cross K/V, frames through `extras`."""
    cfg, _, _, tm, tp = case
    extras = {"frames": _frames(9, cfg)}
    p = _tokens(4, 9)
    solo = generate_greedy(tm, tp, p, 4, max_len=MAX_LEN, extras=extras)
    eng = ServeEngine(tm, params=tp, device="cpu", n_slots=2,
                      max_len=MAX_LEN, page_size=PAGE)
    r = eng.submit(p, max_new_tokens=4, extras=extras)
    eng.run_to_completion()
    assert r.out_tokens == solo, (r.out_tokens, solo)


def test_prefix_cache_keys_pages_by_frames(case):
    """Two requests with equal decoder prompts share their full pages under
    equal frames and none under other frames, as the JAX engine counts;
    tokens equal the cache-off twin's."""
    cfg, jm, jp, tm, tp = case
    p = _tokens(7, 20)
    fa, fb = _frames(11, cfg), _frames(12, cfg)
    traffic = [(p, {"frames": fa}), (p, {"frames": fa}), (p, {"frames": fb})]
    kw = dict(n_slots=1, max_len=MAX_LEN, page_size=PAGE)
    engines = {"jax": JaxEngine(jm, params=jp, prefix_cache=True, **kw),
               "on": ServeEngine(tm, params=tp, device="cpu",
                                 prefix_cache=True, **kw),
               "off": ServeEngine(tm, params=tp, device="cpu",
                                  prefix_cache=False, **kw)}
    tokens, hits = {}, {}
    for name, eng in engines.items():
        tokens[name], hits[name] = [], []
        for prompt, extras in traffic:
            before = eng.stats.prefix_hit_tokens
            r = eng.submit(prompt, max_new_tokens=NEW, extras=extras)
            eng.run_to_completion()
            tokens[name].append(r.out_tokens)
            hits[name].append(eng.stats.prefix_hit_tokens - before)
    assert hits["on"] == hits["jax"] == [0, 16, 0]
    assert tokens["on"] == tokens["jax"] == tokens["off"]
    assert tokens["on"][0] == tokens["on"][1]


def test_dense_attention_over_other_key_counts_is_unmasked_only():
    """`attention` with Sk != Sq: unmasked it is every query row over all
    keys (the reference); causal or windowed it raises ValueError."""
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((1, 5, 2, 1, 32)), dtype=torch.float32)
    k, v = (torch.as_tensor(rng.standard_normal((1, 40, 2, 32)),
                            dtype=torch.float32) for _ in "kv")
    got = tattn.attention(q, k, v, causal=False)
    want = tattn.reference_attention(q, k, v, causal=False)
    torch.testing.assert_close(got, want)
    for kw in (dict(causal=True), dict(causal=False, window=8)):
        with pytest.raises(ValueError, match="Sq 5 != Sk 40"):
            tattn.attention(q, k, v, **kw)


@pytest.mark.parametrize("extras,match", [
    (None, "frames"),
    ({"frames": np.zeros((16, 128), np.float32)}, "frames"),
    ({"patch_embeds": np.zeros((4, 128), np.float32)}, "takes"),
])
def test_submit_refuses_malformed_extras(case, extras, match):
    cfg, _, _, tm, tp = case
    eng = ServeEngine(tm, params=tp, device="cpu", n_slots=1,
                      max_len=MAX_LEN, page_size=PAGE)
    with pytest.raises(ValueError, match=match):
        eng.submit(np.zeros((8,), np.int32), extras=extras)
