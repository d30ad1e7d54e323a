"""Port parity, serving: `repro_torch.serve.engine.ServeEngine` against the
JAX `ServeEngine` on the same mixed-length traffic with the same (bridged)
weights, on smollm-360m `.smoke()` in f32, with the prefix cache off and at
its default (on for the paged chunked engine). Greedy token streams must be
identical and the deterministic counters equal."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ExecOptions, build_model as jbuild
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models.quantized import quantize_params
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import (
    EngineStats, Request, ServeEngine, bucket_length, page_row_of,
    recycle_dead_pages, reserve_page_count)

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

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


@pytest.mark.parametrize("prefix_cache", [False, None])
@pytest.mark.parametrize("kv_dtype,wdtype", [(None, None), ("int8", "int8")])
def test_engine_matches_jax_engine(smol, kv_dtype, wdtype, prefix_cache):
    cfg, jm, jp, tm, tp = smol
    kw = dict(n_slots=3, max_len=96, page_size=8, chunk_pages=2,
              kv_dtype=kv_dtype, wdtype=wdtype, prefix_cache=prefix_cache)
    je = JaxEngine(jm, params=jp, **kw)
    te = ServeEngine(tm, params=tp, device="cpu", **kw)
    assert te.prefix_cache == je.prefix_cache == (prefix_cache is None)
    jr = [je.submit(p, max_new_tokens=6) for p in _prompts()]
    tr = [te.submit(p, max_new_tokens=6) for p in _prompts()]
    je.run_to_completion()
    te.run_to_completion()
    assert all(r.done for r in tr)
    for a, b in zip(jr, tr):
        assert b.out_tokens == a.out_tokens, (a.rid, a.out_tokens, b.out_tokens)
    for name in ("prefill_chunks", "prefill_pad_tokens", "decode_steps",
                 "prefills", "prefill_tokens", "tokens_out",
                 "peak_pages_in_use", "decode_stall_ticks", "prefix_hits",
                 "prefix_misses", "prefix_hit_tokens", "cow_copies",
                 "decode_compiles", "chunk_compiles"):
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


@pytest.mark.parametrize("kw", [
    dict(kv_dtype="fp8"), dict(kv_dtype="e5m2", chunked_prefill=False),
])
def test_unported_engine_options_raise(smol, kw):
    """A paged fp8 engine, chunked or monolithic, raises ValueError, as the
    reference's does (fp8 KV is dense-only in both packages)."""
    cfg, _, _, tm, tp = smol
    with pytest.raises(ValueError, match="fp8"):
        ServeEngine(tm, n_slots=1, max_len=32, params=tp, page_size=8,
                    device="cpu", **kw)


_RECURRENT_REFUSALS = {
    # engine options the reference refuses for recurrent state
    "int8_weights": lambda m, p: ServeEngine(m, params=p, wdtype="int8",
                                             device="cpu"),
    "bf16_kv": lambda m, p: ServeEngine(m, params=p, kv_dtype="bf16",
                                        device="cpu"),
    "int8_kv": lambda m, p: ServeEngine(m, params=p, kv_dtype="int8",
                                        device="cpu"),
    "paged": lambda m, p: ServeEngine(m, params=p, paged=True, device="cpu"),
    "chunked_prefill": lambda m, p: ServeEngine(
        m, params=p, chunked_prefill=True, device="cpu"),
    "prefix_cache": lambda m, p: ServeEngine(m, params=p, prefix_cache=True,
                                             device="cpu"),
    # weights: no int8 datapath, and whole-tree draws only
    "quantize_params": lambda m, p: quantize_params(p, m.cfg),
    "init_int8": lambda m, p: m.init_int8(0),
    "by_layer_draw": lambda m, p: m.init(0, by_layer=True),
}


@pytest.mark.parametrize("refusal", sorted(_RECURRENT_REFUSALS))
@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_recurrent_families_refuse(arch, refusal):
    """The ssm and hybrid families serve dense f32 state with float
    weights: each option the reference's engine refuses for them raises
    ValueError here too (`repro/serve/engine.py:580-624,686-689`,
    `tests/test_int8_decode.py:87-90,262-267`,
    `tests/test_chunked_prefill.py::test_chunked_validation`)."""
    model = build_model(port_config(arch).smoke(), device="cpu")
    with pytest.raises(ValueError):
        _RECURRENT_REFUSALS[refusal](model, model.init(0))


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
