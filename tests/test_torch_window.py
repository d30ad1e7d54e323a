"""Port parity, sliding-window serving: smollm-360m `.smoke()` with
`dataclasses.replace(cfg, window=16)` (the reference's own windowed cases,
`tests/test_chunked_prefill.py`), f32 weights from JAX's init bridged to
torch. Windowed chunked prefill chunks one page at a time and recycles
out-of-window pages between chunks and after every decode step, so a slot
never maps more than `window_page_budget` pages; its streams equal the
windowed `generate_greedy` oracle (dense, exact-length prefill) and the JAX
engine's, with f32 and int8 pools. The paged monolithic and dense windowed
layouts are held to the JAX engine the same way."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ExecOptions, build_model as jbuild
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.engine import generate_greedy as jgreedy

from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine, generate_greedy

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)


def _prompt(seed, n, vocab=512):
    return np.asarray(
        jax.random.randint(jax.random.key(seed), (n,), 0, vocab), np.int32)


@pytest.fixture(scope="module", params=[2, 4])
def windowed(request):
    cfg = dataclasses.replace(get_config("smollm-360m").smoke(), window=16)
    jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=32))
    jp = jm.init(jax.random.key(request.param))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, jp, build_model(cfg, device="cpu"), tp


@pytest.mark.parametrize("kv", [None, "int8"])
def test_windowed_chunked_holds_o_window_pages(windowed, kv):
    """A prompt 3x the window prefills in O(window) pages, stays equal to
    the windowed oracle (the dense int8 oracle for int8 pools) and to the
    JAX engine, and no tick maps more than the window's page budget."""
    cfg, jm, jp, tm, tp = windowed
    p = _prompt(21, 48)
    solo = generate_greedy(tm, tp, p, n_tokens=8, max_len=64, kv_dtype=kv,
                           wdtype=kv)
    assert solo == jgreedy(jm, jp, p, n_tokens=8, max_len=64, kv_dtype=kv,
                           wdtype=kv)
    eng = ServeEngine(tm, n_slots=1, max_len=64, params=tp, page_size=8,
                      kv_dtype=kv, wdtype=kv, device="cpu")
    assert eng.chunked and eng.chunk_tokens == eng.page_size
    assert eng.prefix_cache is False
    r = eng.submit(p, max_new_tokens=8)
    while not r.done:
        eng.step()
        assert eng.stats.pages_in_use <= eng._window_pages()
        assert max(len(m) for m in eng._slot_pages) <= eng._window_pages()
        eng.assert_accounting()
    assert r.out_tokens == solo
    assert eng.stats.peak_pages_in_use <= eng._window_pages() < 8
    assert eng.stats.pages_in_use == 0
    assert eng.pages_allocatable() == eng.n_pages - 1


@pytest.mark.parametrize("layout", [
    dict(), dict(chunked_prefill=False), dict(paged=False)])
def test_windowed_layouts_match_jax_engine(windowed, layout):
    """Mixed-length traffic (prompts shorter and up to 3.5x longer than the
    window) through the chunked, paged monolithic and dense windowed
    engines: the JAX engine's streams and page counters, and the windowed
    oracle's streams."""
    cfg, jm, jp, tm, tp = windowed
    prompts = [_prompt(60 + i, n) for i, n in enumerate((9, 56, 20, 33, 41))]
    kw = dict(n_slots=2, max_len=64, page_size=8, **layout)
    je = JaxEngine(jm, params=jp, **kw)
    te = ServeEngine(tm, params=tp, device="cpu", **kw)
    jr = [je.submit(p, max_new_tokens=6) for p in prompts]
    tr = [te.submit(p, max_new_tokens=6) for p in prompts]
    je.run_to_completion()
    while te._queue or any(s is not None for s in te._slots):
        te.step()
        if te.paged:
            te.assert_accounting()
            assert max(len(m) for m in te._slot_pages) <= te._window_pages()
    for a, b in zip(jr, tr):
        assert b.out_tokens == a.out_tokens, (a.rid, a.out_tokens,
                                              b.out_tokens)
    for name in ("decode_steps", "prefill_chunks", "prefill_tokens",
                 "peak_pages_in_use", "pages_in_use", "tokens_out"):
        assert getattr(te.stats, name) == getattr(je.stats, name), name
    for p, r in zip(prompts, tr):
        assert r.out_tokens == generate_greedy(tm, tp, p, n_tokens=6,
                                               max_len=64)
