"""Port parity, the hybrid family: recurrentgemma-2b `.smoke()` (3 layers
in the (rec, rec, attn) pattern, d_model 128, LRU width 128, 4 query heads
on 1 KV head of 32, local window 64, GeGLU, (1+w) norms, logit softcap
30, vocab 512) in f32 with the JAX package's weights, bridged, against
`repro/models/rglru.py` and the JAX engine.

The RG-LRU scan is a log-depth doubling scan in the port and
`jax.lax.associative_scan` in the JAX package: the same recurrence with
its f32 sums in another order. Tolerances: atol = rtol = 1e-4 on logits
(std ~0.14), the LRU states, conv rows and the attention rings; the scans
against a float64 sequential recurrence at 1e-4, as the reference's own
test holds its scan. Prompts of 60 and 90 tokens and decode past position
64 cover the ring: zero-padded below the window, rolled by S mod window
past it, and wrapped by decode. Token streams and the engine's counters
must equal the JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model as jbuild
from repro.models import rglru as jrglru
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import rglru as trglru
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import (
    ExecOptions, alloc_cache, lm_logits)
from repro_torch.serve.engine import ServeEngine, generate_greedy
from repro_torch.tree import tree_paths

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

ARCH = "recurrentgemma-2b"
TOL = dict(atol=1e-4, rtol=1e-4)
COUNTERS = ("prefills", "prefill_tokens", "prefill_pad_tokens",
            "decode_steps", "tokens_out", "decode_stall_ticks",
            "occupancy_sum", "decode_compiles", "chunk_compiles")
ENGINE_LENS = (7, 40, 70, 12, 33, 90)


@pytest.fixture(scope="module")
def case():
    cfg = get_config(ARCH).smoke()
    jm = jbuild(cfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, jp, build_model(cfg, device="cpu"), tp


@pytest.fixture(scope="module")
def jax_runs(case):
    """Jitted JAX prefill and decode, shared by the module's cases."""
    _, jm, jp, _, _ = case
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode)
    return (lambda toks: prefill(jp, {"tokens": jnp.asarray(toks)}),
            lambda toks, c: decode(jp, {"tokens": jnp.asarray(toks)}, c))


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _jprompt(seed, n=12, vocab=512):
    """The reference tests' prompts (`tests/test_serve.py:_prompt`)."""
    return np.asarray(
        jax.random.randint(jax.random.key(seed), (n,), 0, vocab), np.int32)


def _jcache_tree(cache):
    return {"layers": [dict(lc) for lc in cache["layers"]],
            "pos": cache["pos"]}


def _assert_trees_close(got, want, **tol):
    got = {k: v.double().numpy() for k, v in tree_paths(got).items()}
    want = {k: np.asarray(v, np.float64)
            for k, v in tree_paths(jax.tree.map(
                np.asarray, _jcache_tree(want))).items()}
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


# ------------------------------------------------------------------- RG-LRU
def _scan_inputs(seed, b=2, s=33, w=8):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((b, s, w))))).astype(np.float32)
    gx = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = (rng.standard_normal((b, w)) * 2).astype(np.float32)
    return a, gx, h0


def _sequential(a, gx, h0=None):
    h = np.zeros(a[:, 0].shape) if h0 is None else h0.astype(np.float64)
    out = np.zeros(a.shape)
    for t in range(a.shape[1]):
        h = a[:, t].astype(np.float64) * h + gx[:, t]
        out[:, t] = h
    return out


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_scan_matches_jax(with_h0):
    a, gx, h0 = _scan_inputs(1)
    h0 = h0 if with_h0 else None
    got = trglru.rg_lru_scan(torch.as_tensor(a), torch.as_tensor(gx),
                             None if h0 is None else torch.as_tensor(h0))
    want = jrglru.rg_lru_scan(jnp.asarray(a), jnp.asarray(gx),
                              None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), _sequential(a, gx, h0), **TOL)


@pytest.mark.parametrize("s", [50, 64])
def test_rg_lru_scan_chunked_matches_jax(s):
    """Chunks of 16 carrying h (the JAX function scans whole chunks at 64
    and, at a ragged 50, the whole sequence at once), from a given h0."""
    a, gx, h0 = _scan_inputs(s, s=s)
    got = trglru.rg_lru_scan_chunked(torch.as_tensor(a), torch.as_tensor(gx),
                                     torch.as_tensor(h0), chunk=16)
    want = jrglru.rg_lru_scan_chunked(jnp.asarray(a), jnp.asarray(gx),
                                      jnp.asarray(h0), chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), _sequential(a, gx, h0), **TOL)


def test_rg_lru_stability():
    """`tests/test_ssm_rglru.py::test_rg_lru_stability`: |a| < 1 keeps the
    state bounded over 4096 steps, whole or in chunks."""
    a = torch.full((1, 4096, 4), 0.999)
    gx = torch.ones((1, 4096, 4)) * 0.01
    for out in (trglru.rg_lru_scan(a, gx),
                trglru.rg_lru_scan_chunked(a, gx, chunk=256)):
        assert bool(torch.isfinite(out).all())
        assert float(out.abs().max()) < 11.0  # <= gx / (1 - a) = 10


@pytest.mark.parametrize("s", [5, 64, 131])
def test_ring_keeps_the_window(s):
    """Row p of the ring holds position p' = p mod window of the last
    `window` positions; zero rows past S."""
    rows = torch.arange(s, dtype=torch.float32)[None, :, None, None] + 1
    ring = trglru.ring_of(rows, 64)[0, :, 0, 0]
    for slot in range(64):
        live = [p for p in range(max(0, s - 64), s) if p % 64 == slot]
        assert ring[slot].item() == (live[0] + 1 if live else 0)


# -------------------------------------------------------------- model level
def test_bridge_carries_the_hybrid_tree(case):
    """rec (18 at full width), attn (8) and mlp (26) stacks: the smoke
    config's 2, 1 and 3, leaf for leaf."""
    cfg, _, _, tm, tp = case
    mine = tree_paths(tm.init(seed=0))
    got = tree_paths(tp)
    assert sorted(got) == sorted(mine)
    for path, leaf in mine.items():
        assert got[path].shape == leaf.shape and got[path].dtype == leaf.dtype
    assert (tp["rec"]["in_x"].shape[0], tp["attn"]["wq"].shape[0],
            tp["mlp"]["w1"].shape[0]) == (2, 1, 3)
    full = build_model(get_config(ARCH), device="cpu").schema
    assert (full["rec"]["in_x"].shape[0], full["attn"]["wq"].shape[0],
            full["mlp"]["w1"].shape[0]) == (18, 8, 26)


@pytest.mark.parametrize("s", [7, 60, 90])
def test_prefill_logits_and_state(case, jax_runs, s):
    """Softcapped prefill logits, every LRU state and conv row, and each
    attention layer's ring (90 is past the window of 64)."""
    cfg, _, _, tm, tp = case
    toks = _tokens(s, (1, s))
    jl, jc = jax_runs[0](toks)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(tl.abs().max()) < cfg.logit_softcap
    _assert_trees_close(tc, jc, **TOL)


def test_decode_steps_match_jax(case, jax_runs):
    """Prefill 60 tokens (B = 2), then eight decode steps that wrap the
    ring at position 64: logits and the state after each step."""
    cfg, _, _, tm, tp = case
    toks = _tokens(3, (2, 60))
    _, jc = jax_runs[0](toks)
    _, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    for step in range(8):
        nxt = _tokens(10 + step, (2, 1))
        jl, jc = jax_runs[1](nxt, jc)
        tl, tc = tm.decode(tp, {"tokens": torch.as_tensor(nxt)}, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_trees_close(tc, jc, **TOL)
    assert tc["pos"].tolist() == [68, 68]


def test_decode_continues_prefill(case):
    """Teacher-forced: a 60-token prefill and decode steps through the
    ring's wrap give the logits of a cacheless windowed pass over the
    whole sequence at every position."""
    cfg, _, _, tm, tp = case
    toks = _tokens(4, (1, 70))
    hidden, _ = trglru.forward(tp, torch.as_tensor(toks), cfg, None,
                               mode="prefill")
    full = lm_logits(tp, hidden, cfg)
    _, cache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :60])})
    for t in range(60, 70):
        got, cache = tm.decode(
            tp, {"tokens": torch.as_tensor(toks[:, t:t + 1])}, cache)
        np.testing.assert_allclose(got[0, 0].numpy(), full[0, t].numpy(),
                                   **TOL)


def test_train_loss_matches_jax(case):
    cfg, jm, jp, tm, tp = case
    toks = _tokens(6, (2, 64))
    labels = np.roll(toks, -1, axis=1)
    jl, _ = jm.train_loss(jp, {"tokens": jnp.asarray(toks),
                               "labels": jnp.asarray(labels)})
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    tl, _ = tm.train_loss(tp, batch, ce_chunk=32)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tree_paths(tp).items()}
    from repro_torch.tree import tree_from_paths
    loss, _ = tm.train_loss(tree_from_paths(leaves), batch, ce_chunk=32,
                            remat="full")
    loss.backward()
    np.testing.assert_allclose(loss.item(), tl.item(), rtol=1e-6)
    assert all(torch.isfinite(v.grad).all() for v in leaves.values())


def test_cache_shape_is_o_window(case):
    cfg, jm, _, tm, _ = case
    shapes = tm.cache_shape(3, 64, torch.float32)
    assert shapes == tm.cache_shape(3, 4096, torch.float32)
    got = {k: tuple(v.shape)
           for k, v in tree_paths(alloc_cache(shapes, "cpu")).items()}
    want = jm.cache_shape(3, 64, jnp.float32)
    assert got == {k: tuple(v.shape)
                   for k, v in tree_paths(_jcache_tree(want)).items()}


# ------------------------------------------------------------------- engine
def _traffic(sampled):
    reqs = []
    for i, n in enumerate(ENGINE_LENS):
        kw = {}
        if sampled:
            kw = dict(sample_params=(0.8, 20, 0.9) if i % 3 else None,
                      seed=3 + i, rep_penalty=1.3 if i % 2 else 1.0,
                      logit_bias={5: 2.0, 7: -1.5} if i % 3 == 0 else None)
        reqs.append((_tokens(20 + i, n), kw))
    return reqs


def _serve(eng, traffic, new=6):
    reqs = [eng.submit(p, max_new_tokens=new, **kw) for p, kw in traffic]
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], {c: getattr(eng.stats, c)
                                          for c in COUNTERS}


@pytest.mark.parametrize("sampled", [False, True])
def test_engine_matches_jax_engine(case, sampled):
    """Six requests over two slots (slot reuse; 70 + 6 wraps the ring in
    decode, 90 in prefill), greedy, or sampled with a repetition penalty
    and logit bias that apply to the first token: tokens and counters equal
    the JAX engine's."""
    cfg, jm, jp, tm, tp = case
    traffic = _traffic(sampled)
    want = _serve(JaxEngine(jm, params=jp, n_slots=2, max_len=128), traffic)
    eng = ServeEngine(tm, params=tp, n_slots=2, max_len=128, device="cpu")
    assert not eng.paged and not eng.chunked and not eng.bucket_prompts
    assert _serve(eng, traffic) == want


# ------------------------------------------------ the reference's own cases
def test_engine_state_families(case):
    """`tests/test_serve.py::test_engine_state_families` (hybrid)."""
    cfg, _, _, tm, tp = case
    solo = generate_greedy(tm, tp, _jprompt(7), n_tokens=4, max_len=64)
    eng = ServeEngine(tm, n_slots=2, max_len=64, params=tp, device="cpu")
    r1 = eng.submit(_jprompt(7), max_new_tokens=4)
    r2 = eng.submit(_jprompt(8), max_new_tokens=4)
    eng.run_to_completion()
    assert r1.out_tokens == solo
    assert len(r2.out_tokens) == 4


def test_state_families_stay_exact(case):
    """`tests/test_serve_fastpath.py::test_state_families_stay_exact`."""
    cfg, _, _, tm, tp = case
    eng = ServeEngine(tm, n_slots=2, max_len=64, params=tp, device="cpu")
    assert not eng.bucket_prompts
    solo = {n: generate_greedy(tm, tp, _jprompt(n, n), n_tokens=3,
                               max_len=64) for n in (7, 12)}
    reqs = {n: eng.submit(_jprompt(n, n), max_new_tokens=3) for n in (7, 12)}
    eng.run_to_completion()
    for n, r in reqs.items():
        assert r.out_tokens == solo[n], (n, r.out_tokens, solo[n])


def test_idle_slots_leave_live_ones_alone(case):
    """A live slot's stream is the oracle's while the other slots sit idle
    or retire early (their rows still run in every decode step)."""
    cfg, _, _, tm, tp = case
    long = _tokens(50, 70)
    solo = generate_greedy(tm, tp, long, 10, max_len=128)
    eng = ServeEngine(tm, n_slots=4, max_len=128, params=tp, device="cpu")
    r = eng.submit(long, max_new_tokens=10)
    short = eng.submit(_tokens(51, 9), max_new_tokens=2)
    eng.run_to_completion()
    assert r.out_tokens == solo and len(short.out_tokens) == 2


def test_prompt_past_the_attention_chunk_serves(case):
    """A prompt longer than the blockwise attention's 1024-row chunk and
    not a multiple of it (1100 tokens; the reference asserts S % chunk ==
    0) prefills through `chunked_attention`'s ragged last block: the
    engine's tokens equal those of the same weights whose attention is the
    whole-prompt `reference_attention`, and its first logits agree."""
    cfg, _, _, tm, tp = case
    prompt = _tokens(31, (1100,))
    eng = ServeEngine(tm, n_slots=2, max_len=1152, params=tp, device="cpu",
                      keep_logits=True)
    r = eng.submit(prompt, max_new_tokens=6)
    eng.run_to_completion()
    ref = build_model(cfg, ExecOptions(attn_impl="reference"), device="cpu")
    ref_eng = ServeEngine(ref, n_slots=1, max_len=1152, params=tp,
                          device="cpu", keep_logits=True)
    want = ref_eng.submit(prompt, max_new_tokens=6)
    ref_eng.run_to_completion()
    assert r.done and r.out_tokens == want.out_tokens
    np.testing.assert_allclose(r.logits[0].numpy(), want.logits[0].numpy(),
                               **TOL)


@pytest.mark.parametrize("extra", [[], ["--int8"]])
def test_serve_cli_smoke_on_cpu(capsys, extra):
    """`--arch recurrentgemma-2b --smoke --device cpu` serves every request
    dense; `--int8` is the reference CLI's generic QDQ."""
    stats = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "3", "--slots", "2", "--max-len",
                            "64", "--new-tokens", "3"] + extra)
    assert stats.tokens_out == 9 and stats.pages_in_use == 0
    assert "3/3 done" in capsys.readouterr().out
