"""Port parity, prefix cache with copy-on-write pages: the port's
`ServeEngine` against the JAX engine on the reference's own cases
(`tests/test_prefix_cache.py`, single-host), on smollm-360m `.smoke()` in f32
with JAX-initialised weights bridged to torch. Every case runs the same
submissions through both engines and holds the port to the JAX engine's
token streams, first-token ticks and counters, plus the reference's own
assertions. The reference's prefix trace runs in
`tests/test_torch_prefix_trace.py` (its nine legs take most of the time,
so `--dist loadfile` can put them on another worker).

Waits for later items: `test_squeeze_steals_cached_pages_with_parity`
(fault plans, A11) and the sharded cases (A12). The LRU eviction case runs
at a worst-case pool (smaller pools are A11) with enough distinct prompts
to drain the free list into the LRU."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ExecOptions, build_model as jbuild
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.bridge import params_from_numpy
from repro_torch.models import transformer as ttransformer
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import (
    ServeEngine, lookup_prefix_hits, prefix_digests, prefix_share_plan,
    register_prefix_pages, request_seed_digest)

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

STATS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens", "cow_copies",
         "prefix_evictions", "prefix_cached_pages", "prefill_chunks",
         "prefill_tokens", "prefill_pad_tokens", "peak_pages_in_use",
         "pages_in_use", "decode_steps", "tokens_out", "prefills")


def _pair(arch, seed=0, moe_group=None):
    cfg = get_config(arch).smoke()
    jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=32,
                                 moe_group=moe_group))
    jp = jm.init(jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tm = build_model(cfg, ttransformer.ExecOptions(moe_group=moe_group),
                     device="cpu")
    return cfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def smol():
    return _pair("smollm-360m")


def _prompt(seed, n=12, vocab=512):
    return np.asarray(
        jax.random.randint(jax.random.key(seed), (n,), 0, vocab), np.int32)


def _makers(pair):
    """{"jax": make, "torch": make}: engine constructors with the test's
    defaults (4 slots, max_len 96, page 8, one-page chunks)."""
    _, jm, jp, tm, tp = pair

    def kw_of(kw):
        kw = dict(kw)
        for k, v in (("n_slots", 4), ("max_len", 96), ("page_size", 8),
                     ("chunk_pages", 1)):
            kw.setdefault(k, v)
        return kw

    return {"jax": lambda cache=None, **kw: JaxEngine(
                jm, params=jp, prefix_cache=cache, **kw_of(kw)),
            "torch": lambda cache=None, **kw: ServeEngine(
                tm, params=tp, prefix_cache=cache, device="cpu",
                **kw_of(kw))}


def _both(pair, scenario):
    """Run `scenario(make)` on both engines; hold the port's token streams,
    first-token ticks and counters to the JAX engine's. Returns the port's
    (engine(s), requests) result."""
    out = {}
    for name, make in _makers(pair).items():
        out[name] = scenario(make)
    (jengs, jreqs), (tengs, treqs) = out["jax"], out["torch"]
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.first_token_tick for r in treqs] \
        == [r.first_token_tick for r in jreqs]
    assert [r.cached_prompt_tokens for r in treqs] \
        == [r.cached_prompt_tokens for r in jreqs]
    for je, te in zip(jengs, tengs):
        for name in STATS:
            assert getattr(te.stats, name) == getattr(je.stats, name), name
        te.assert_accounting()
    return tengs, treqs


def _shared_wave(eng, sysp, n=4, new=6, sample=False):
    """Warmup registers `sysp`; returns [warmup] + wave after completion."""
    warm = eng.submit(sysp, max_new_tokens=4)
    eng.run_to_completion()
    wave = []
    for i in range(n):
        tail = _prompt(100 + i, 4 + 3 * i)
        sp = (0.8, 40, 0.95) if sample and i % 2 else None
        wave.append(eng.submit(np.concatenate([sysp, tail]),
                               max_new_tokens=new, sample_params=sp,
                               seed=50 + i))
    eng.run_to_completion()
    return [warm] + wave


def test_helpers_match_jax():
    from repro.serve import engine as je
    rng = np.random.default_rng(0)
    lp = rng.integers(0, 512, 45).astype(np.int32)
    extras = {"frames": rng.standard_normal((3, 4)).astype(np.float32)}
    for ex in (None, extras):
        seed = request_seed_digest(ex)
        assert seed == je.request_seed_digest(ex)
        assert prefix_digests(lp, 8, 5, seed) == \
            je.prefix_digests(lp, 8, 5, seed)
        mapping = {j: 10 + j for j in range(5)}
        a, b = ({}, {}), ({}, {})
        register_prefix_pages(mapping, lp, 8, seed, *a)
        je.register_prefix_pages(mapping, lp, 8, seed, *b)
        assert a == b
        for n in (3, 16, 45):
            assert lookup_prefix_hits(a[1], lp[:n], 8, seed) == \
                je.lookup_prefix_hits(b[1], lp[:n], 8, seed)
    for plen in (7, 8, 9, 16, 40):
        for hits in ([], [3], [3, 4], [3, 4, 5, 6, 7]):
            assert prefix_share_plan(plen, hits, 8) == \
                je.prefix_share_plan(plen, hits, 8)


# ------------------------------------------------------------- token parity
def test_shared_prefix_parity_and_page_savings(smol):
    """Cached vs cache-off twins on the same warmup + shared-prefix wave,
    greedy and sampled: identical streams, fewer peak pages, 4 hits of 48
    tokens each, fewer prefilled tokens; both engines as the JAX engine."""
    sysp = _prompt(7, 48)
    legs = {}
    for cache in (True, False):
        engs, reqs = _both(smol, lambda make: (
            lambda e: ([e], _shared_wave(e, sysp, sample=True)))(make(cache)))
        legs[cache] = (engs[0], [r.out_tokens for r in reqs])
    eng_c, toks_c = legs[True]
    eng_u, toks_u = legs[False]
    assert toks_c == toks_u
    assert eng_c.stats.peak_pages_in_use < eng_u.stats.peak_pages_in_use
    assert eng_c.stats.prefix_hits == 4
    assert eng_c.stats.prefix_hit_tokens == 4 * 48
    assert eng_u.stats.prefix_hits == eng_u.stats.prefix_misses == 0
    assert eng_c.stats.prefill_tokens < eng_u.stats.prefill_tokens
    for eng in (eng_c, eng_u):
        assert eng.stats.pages_in_use == 0
        assert eng.pages_allocatable() == eng.n_pages - 1


def test_full_hit_skips_prefill_entirely(smol):
    """A page-aligned duplicate prompt hits every page: the last one is
    cloned, no chunk runs, and the first token comes on the next tick."""
    sysp = _prompt(3, 32)

    def scenario(make):
        eng = make(True)
        warm = eng.submit(sysp, max_new_tokens=4)
        eng.run_to_completion()
        chunks0 = eng.stats.prefill_chunks
        dup = eng.submit(sysp.copy(), max_new_tokens=4)
        eng.run_to_completion()
        assert eng.stats.prefill_chunks == chunks0
        return [eng], [warm, dup]

    (eng,), (warm, dup) = _both(smol, scenario)
    assert dup.out_tokens == warm.out_tokens
    assert eng.stats.cow_copies == 1
    assert eng.stats.prefix_hit_tokens == 32
    assert dup.first_token_tick - dup.submit_tick == 1


def test_divergence_inside_first_page_shares_nothing(smol):
    a = _prompt(11, 24)
    b = a.copy()
    b[2] = (b[2] + 1) % 512

    def scenario(make):
        eng = make(True)
        ra = eng.submit(a, max_new_tokens=4)
        eng.run_to_completion()
        rb = eng.submit(b, max_new_tokens=4)
        eng.run_to_completion()
        fresh = make(False)
        fa = fresh.submit(a, max_new_tokens=4)
        fb = fresh.submit(b, max_new_tokens=4)
        fresh.run_to_completion()
        return [eng, fresh], [ra, rb, fa, fb]

    (eng, _), (ra, rb, fa, fb) = _both(smol, scenario)
    assert eng.stats.prefix_hits == 0 and eng.stats.prefix_hit_tokens == 0
    assert ra.out_tokens == fa.out_tokens
    assert rb.out_tokens == fb.out_tokens


def test_prompt_shorter_than_one_page(smol):
    p = _prompt(5, 5)

    def scenario(make):
        eng = make(True)
        r1 = eng.submit(p, max_new_tokens=4)
        eng.run_to_completion()
        r2 = eng.submit(p.copy(), max_new_tokens=4)
        eng.run_to_completion()
        return [eng], [r1, r2]

    (eng,), (r1, r2) = _both(smol, scenario)
    assert r1.out_tokens == r2.out_tokens
    assert eng.stats.prefix_hits == 0
    assert eng.stats.prefix_cached_pages == 0
    assert eng.pages_allocatable() == eng.n_pages - 1


def test_in_flight_duplicates_wait_for_the_first(smol):
    """Two copies of one fresh prompt submitted back to back: the second
    waits while the first prefills (in-flight dedup), then hits its pages."""
    p = _prompt(8, 36)

    def scenario(make):
        eng = make(True)
        r1 = eng.submit(p, max_new_tokens=4)
        r2 = eng.submit(p.copy(), max_new_tokens=4)
        eng.run_to_completion()
        return [eng], [r1, r2]

    (eng,), (r1, r2) = _both(smol, scenario)
    assert r1.out_tokens == r2.out_tokens
    assert eng.stats.prefix_hits == 1
    assert r2.cached_prompt_tokens == 32
    assert r2.first_token_tick > r1.first_token_tick


# -------------------------------------------------------- retirement paths
def test_cancel_mid_prefill_on_shared_pages(smol):
    """Cancelling a sharer mid-prefill decrefs its shared pages without
    freeing the registry copy the other sharer still reads."""
    sysp = _prompt(9, 48)
    tail_a, tail_b = _prompt(201, 17), _prompt(202, 17)

    def scenario(make):
        eng = make(True, n_slots=2)
        warm = eng.submit(sysp, max_new_tokens=4)
        eng.run_to_completion()
        ra = eng.submit(np.concatenate([sysp, tail_a]), max_new_tokens=4)
        rb = eng.submit(np.concatenate([sysp, tail_b]), max_new_tokens=4)
        eng.step()
        assert eng.stats.prefix_hits == 2
        eng.cancel(ra)
        eng.assert_accounting()
        eng.run_to_completion()
        twin = make(True, n_slots=2)
        tw = twin.submit(sysp, max_new_tokens=4)
        twin.run_to_completion()
        tb = twin.submit(np.concatenate([sysp, tail_b]), max_new_tokens=4)
        twin.run_to_completion()
        return [eng, twin], [warm, ra, rb, tw, tb]

    (eng, _), (warm, ra, rb, tw, tb) = _both(smol, scenario)
    assert not ra.out_tokens and rb.done
    assert tw.out_tokens == warm.out_tokens
    assert tb.out_tokens == rb.out_tokens
    assert eng.pages_allocatable() == eng.n_pages - 1


def test_lru_eviction_under_pool_pressure(smol):
    """At a worst-case pool (2 slots x 8 pages + the null page), distinct
    prompts park their registered pages in the LRU until the free list runs
    dry; then new traffic evicts cached pages oldest first, the evicted
    prefix stops hitting, and it decodes as before when resubmitted."""
    sysp = _prompt(13, 24)                     # 3 registered pages

    def scenario(make):
        eng = make(True, n_slots=2, max_len=64)
        warm = eng.submit(sysp, max_new_tokens=4)
        eng.run_to_completion()
        assert eng.stats.prefix_cached_pages == 3
        fill = [eng.submit(_prompt(300 + i, 40), max_new_tokens=4)
                for i in range(3)]             # 5 registered pages each
        eng.run_to_completion()
        assert eng.stats.prefix_evictions > 0
        again = eng.submit(sysp.copy(), max_new_tokens=4)
        eng.run_to_completion()
        return [eng], [warm] + fill + [again]

    (eng,), reqs = _both(smol, scenario)
    warm, again = reqs[0], reqs[-1]
    assert again.out_tokens == warm.out_tokens
    assert again.cached_prompt_tokens == 0     # its pages were evicted
    assert eng.pages_allocatable() == eng.n_pages - 1


# ------------------------------------------------------------ configuration
def test_window_silently_disables_prefix_cache(smol):
    import dataclasses
    cfg = get_config("smollm-360m").smoke()
    wcfg = dataclasses.replace(cfg, window=16)
    jm = jbuild(wcfg, ExecOptions(attn_impl="reference", ce_chunk=32))
    jp = jm.init(jax.random.key(2))
    pair = (wcfg, jm, jp, build_model(wcfg, device="cpu"),
            params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    p = _prompt(19, 40)

    def scenario(make):
        eng = make(True, n_slots=2, chunk_pages=2)
        assert eng.prefix_cache is False
        r1 = eng.submit(p, max_new_tokens=4)
        eng.run_to_completion()
        r2 = eng.submit(p.copy(), max_new_tokens=4)
        eng.run_to_completion()
        return [eng], [r1, r2]

    (eng,), (r1, r2) = _both(pair, scenario)
    assert r1.out_tokens == r2.out_tokens
    assert eng.stats.prefix_hits == 0


def test_explicit_prefix_cache_needs_paged_chunked(smol):
    _, _, _, tm, tp = smol
    with pytest.raises(ValueError):
        ServeEngine(tm, n_slots=2, max_len=64, params=tp, paged=False,
                    prefix_cache=True, device="cpu")
    with pytest.raises(ValueError):
        ServeEngine(tm, n_slots=2, max_len=64, params=tp, page_size=8,
                    chunked_prefill=False, prefix_cache=True, device="cpu")
    eng = ServeEngine(tm, n_slots=2, max_len=64, params=tp, page_size=8,
                      prefix_cache=False, device="cpu")
    r = eng.submit(_prompt(1, 20), max_new_tokens=4)
    eng.run_to_completion()
    assert r.done
    eng.assert_accounting()


@pytest.mark.parametrize("paged,chunked,want", [
    (None, None, True), (True, False, False), (False, False, False)])
def test_prefix_cache_none_resolves_as_jax(smol, paged, chunked, want):
    _, jm, jp, tm, tp = smol
    kw = dict(n_slots=2, max_len=64, paged=paged, chunked_prefill=chunked)
    te = ServeEngine(tm, params=tp, device="cpu", **kw)
    je = JaxEngine(jm, params=jp, **kw)
    assert te.prefix_cache == je.prefix_cache == want


def test_ttft_tpot_percentiles_in_summary(smol):
    _, jm, jp, tm, tp = smol
    eng = ServeEngine(tm, n_slots=4, max_len=96, params=tp, page_size=8,
                      device="cpu")
    for i in range(3):
        eng.submit(_prompt(30 + i, 10 + 5 * i), max_new_tokens=6)
    eng.run_to_completion()
    s = eng.stats.summary()
    for k in ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s"):
        assert k in s and s[k] >= 0.0
    assert s["ttft_p50_s"] > 0.0 and s["ttft_p99_s"] >= s["ttft_p50_s"]
    # the port's keys are the reference's, less the counters of what the
    # port does not have (jit compiles)
    je = JaxEngine(jm, params=jp, n_slots=1, max_len=32)
    absent = {"prefill_compiles", "decode_compiles", "paste_compiles",
              "chunk_compiles"}
    assert set(s) == set(je.stats.summary()) - absent


# ------------------------------------------------ the reference's trace
