"""Port parity, serving: `repro_torch.serve.engine.ServeEngine` against the
JAX `ServeEngine(prefix_cache=False)` on the same mixed-length traffic with
the same (bridged) weights, on smollm-360m `.smoke()` in f32. Greedy token
streams must be identical and the deterministic counters equal."""

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import ExecOptions, build_model as jbuild
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import (
    EngineStats, Request, ServeEngine, bucket_length, page_row_of,
    recycle_dead_pages, reserve_page_count)

# prompt lengths around page (8) and chunk (16) edges, one past 4 chunks
LENGTHS = (12, 70, 9, 33, 16, 17, 41)


@pytest.fixture(scope="module")
def smol():
    cfg = get_config("smollm-360m").smoke()
    jm = jbuild(cfg, ExecOptions(attn_impl="reference"))
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, jp, build_model(cfg, device="cpu"), tp


def _prompts(vocab=512):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


@pytest.mark.parametrize("kv_dtype,wdtype", [(None, None), ("int8", "int8")])
def test_engine_matches_jax_engine(smol, kv_dtype, wdtype):
    cfg, jm, jp, tm, tp = smol
    kw = dict(n_slots=3, max_len=96, page_size=8, chunk_pages=2,
              kv_dtype=kv_dtype, wdtype=wdtype)
    je = JaxEngine(jm, params=jp, prefix_cache=False, **kw)
    te = ServeEngine(tm, params=tp, device="cpu", **kw)
    jr = [je.submit(p, max_new_tokens=6) for p in _prompts()]
    tr = [te.submit(p, max_new_tokens=6) for p in _prompts()]
    je.run_to_completion()
    te.run_to_completion()
    assert all(r.done for r in tr)
    for a, b in zip(jr, tr):
        assert b.out_tokens == a.out_tokens, (a.rid, a.out_tokens, b.out_tokens)
    for name in ("prefill_chunks", "prefill_pad_tokens", "decode_steps",
                 "prefills", "prefill_tokens", "tokens_out",
                 "peak_pages_in_use", "decode_stall_ticks"):
        assert getattr(te.stats, name) == getattr(je.stats, name), name
    assert te.stats.pages_in_use == je.stats.pages_in_use == 0
    te.assert_accounting()
    assert te.pages_allocatable() == te.n_pages - 1
    s = te.stats.summary()
    assert s["ttft_p50_s"] > 0 and s["mean_occupancy"] > 0


def test_cancel_mid_prefill_returns_every_page(smol):
    cfg, _, _, tm, tp = smol
    eng = ServeEngine(tm, n_slots=2, max_len=64, params=tp, page_size=8,
                      device="cpu")
    long = eng.submit(np.arange(50, dtype=np.int32) % 512, max_new_tokens=4)
    queued = [eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=2)
              for _ in range(3)]
    eng.step()                                  # long is mid-prefill
    assert eng.stats.pages_in_use > 0 and not long.done
    eng.cancel(long)
    eng.cancel(queued[-1])
    eng.assert_accounting()
    eng.run_to_completion()
    assert long.done and not long.out_tokens
    assert all(len(r.out_tokens) == 2 for r in queued[:-1])
    assert eng.stats.pages_in_use == 0
    eng.assert_accounting()


def test_submit_validation(smol):
    cfg, _, _, tm, tp = smol
    eng = ServeEngine(tm, n_slots=1, max_len=32, params=tp, page_size=8,
                      device="cpu")
    for bad in (np.zeros((2, 2), np.int32), np.zeros((0,), np.int32),
                np.zeros((33,), np.int32)):
        with pytest.raises(ValueError):
            eng.submit(bad)
    with pytest.raises(ValueError):
        eng.submit(np.zeros((4,), np.int32), max_new_tokens=0)
    r = eng.submit(np.zeros((32,), np.int32), max_new_tokens=4)
    eng.run_to_completion()
    assert r.out_tokens and len(r.out_tokens) == 1   # cache full after replay


@pytest.mark.parametrize("kw,item", [
    (dict(prefix_cache=True), "A7"), (dict(paged=False), "A6"),
    (dict(chunked_prefill=False), "A6"), (dict(ttl_ticks=3), "A11"),
    (dict(n_pages=3), "A11"),
])
def test_unported_engine_options_raise(smol, kw, item):
    cfg, _, _, tm, tp = smol
    with pytest.raises(NotImplementedError, match=item):
        ServeEngine(tm, n_slots=1, max_len=32, params=tp, page_size=8,
                    device="cpu", **kw)


def test_unported_request_options_raise(smol):
    cfg, _, _, tm, tp = smol
    eng = ServeEngine(tm, n_slots=1, max_len=32, params=tp, page_size=8,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        eng.submit(np.zeros((4,), np.int32), sample_params=(1.0, 0, 1.0))
    with pytest.raises(NotImplementedError, match="A8"):
        eng.submit(np.zeros((4,), np.int32), rep_penalty=1.3)


def test_windowed_config_raises():
    cfg = get_config("smollm-360m").smoke()
    import dataclasses
    windowed = build_model(dataclasses.replace(cfg, window=16), device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        ServeEngine(windowed, n_slots=1, max_len=32, params=windowed.init(0),
                    page_size=8, device="cpu")


def test_bookkeeping_helpers_match_jax():
    from repro.serve import engine as je
    for plen, new in ((5, 3), (30, 40), (64, 1)):
        for window in (0, 16):
            kw = dict(max_len=64, page_size=8, window=window)
            assert reserve_page_count(plen, new, **kw) == \
                je.reserve_page_count(plen, new, **kw)
        assert bucket_length(plen, 64) == je.bucket_length(plen, 64)
    m1, m2 = {0: 3, 1: 5, 2: 9}, {0: 3, 1: 5, 2: 9}
    assert recycle_dead_pages(m1, 5, 8, 8, 26) == \
        je.recycle_dead_pages(m2, 5, 8, 8, 26)
    assert m1 == m2
    np.testing.assert_array_equal(page_row_of(m1, 6), je.page_row_of(m2, 6))
    stats = EngineStats()
    r = Request(rid=1, prompt=np.zeros(3, np.int32), out_tokens=[1, 2, 3],
                t_enqueue=0.0, t_first_token=1.0, t_done=3.0)
    stats.record_request(r)
    s = stats.summary()
    assert s["ttft_p50_s"] == 1.0 and s["tpot_p50_s"] == 1.0
    assert EngineStats().summary()["pad_waste_ratio"] == 0.0
