"""Port parity, sharded serving counters on 8 shards: the cases of
`tests/test_sharded_serve.py` (dense in f32 with budgets that retire
mid-stream, int8 weights and KV, seeded sampling, a window of 16, a
mid-prefill cancel; moe in f32 and int8) and
`tests/test_prefix_cache.py::test_sharded_prefix_parity_8dev` (cache-aware
placement, cache on and off) run in a JAX subprocess on a forced 8-device
mesh (the harness of `tests/test_torch_migration.py`) and in the port;
tokens, prefill chunks, decode steps, prefix hits, COW copies, peak pages
and `shard_summary()` must be equal, and the reference tests' own gates
hold on the port's runs."""

import importlib.util
import os

import numpy as np
import pytest
import torch

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_migration_harness",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "test_torch_migration.py"))
H = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(H)
Api, prompt, summary = H.Api, H.prompt, H.summary
INT8 = {"wdtype": "int8", "kv_dtype": "int8"}


def _serve_case(arch, key=1, window=None, lens=(), new=None, sample=None,
                **kw):
    def run(api):
        eng = api.engine(arch, 8, key, window, n_slots=8, max_len=64,
                         page_size=8, **kw)
        reqs = [eng.submit(prompt(i, n), max_new_tokens=m,
                           sample_params=sample, seed=100 + i)
                for i, (n, m) in enumerate(
                    zip(lens, new or [4] * len(lens)))]
        eng.run_to_completion()
        eng.assert_local_page_tables()
        assert eng.stats.pages_in_use == 0
        return summary(eng, reqs,
                       window_pages=eng._sched._window_pages()
                       if window else 0)
    return run


def cancel_8dev(api):
    eng = api.engine("smollm-360m", 8, n_slots=8, max_len=64, page_size=8)
    r_long = eng.submit(prompt(0, 40), max_new_tokens=4)
    r_short = eng.submit(prompt(1, 9), max_new_tokens=4)
    eng.step()
    eng.cancel(r_long)
    eng.run_to_completion()
    return summary(eng, [r_long, r_short])


def prefix_8dev(api):
    """`tests/test_prefix_cache.py:370`, both legs."""
    sysp = prompt(7, 24)
    out = {}
    for cache in (True, False):
        eng = api.engine("smollm-360m", 8, n_slots=16, max_len=64,
                         page_size=8, chunk_pages=1, prefix_cache=cache)
        warm = eng.submit(sysp, max_new_tokens=4)
        eng.run_to_completion()
        reqs = [eng.submit(np.concatenate([sysp, prompt(100 + i, 5 + i)]),
                           max_new_tokens=6, seed=50 + i) for i in range(4)]
        reqs.append(eng.submit(prompt(40, 5), max_new_tokens=6))
        eng.run_to_completion()
        dup = eng.submit(sysp.copy(), max_new_tokens=4)
        eng.run_to_completion()
        eng.assert_pool_accounting()
        eng.assert_local_page_tables()
        out[cache] = summary(eng, [warm] + reqs + [dup])
    res = dict(out[True])
    res["off"] = out[False]
    return res


SCENARIOS = {
    "serve_dense_f32": _serve_case("smollm-360m", lens=[9, 17, 6, 23, 13, 31],
                                   new=[2, 8, 4, 1, 6, 3]),
    "serve_dense_int8": _serve_case("smollm-360m", lens=[9, 17, 6], **INT8),
    "serve_dense_sampled": _serve_case("smollm-360m", lens=[9, 17, 6],
                                       sample=(0.8, 20, 0.9)),
    "serve_window16": _serve_case("smollm-360m", key=2, window=16,
                                  lens=[40, 30], new=[8, 8]),
    "serve_cancel": cancel_8dev,
    "serve_moe_f32": _serve_case("qwen2-moe-a2.7b", key=3, lens=[9, 17],
                                 new=[3, 3]),
    "serve_moe_int8": _serve_case("qwen2-moe-a2.7b", key=3, lens=[17],
                                  new=[3], **INT8),
    "prefix_8dev": prefix_8dev,
}


@pytest.fixture(scope="module")
def reference():
    res = H.JaxResults(os.path.abspath(__file__))
    yield res
    res.close()


@pytest.fixture(scope="module")
def port(reference):
    return H.run_scenarios(Api("torch"), SCENARIOS)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, reference, port):
    H.assert_same(port[name], reference.get()[name], name)


def test_scenario_gates(port):
    """The reference tests' own gates on the port's runs."""
    w = port["serve_window16"]
    assert w["counters"]["peak_pages_in_use"] <= 8 * w["window_pages"]
    p = port["prefix_8dev"]
    assert p["tokens"] == p["off"]["tokens"]
    assert p["tokens"][-1] == p["tokens"][0]       # the dup replays warm-up
    assert p["counters"]["prefix_hits"] >= 3
    assert p["counters"]["cow_copies"] >= 1
    assert p["counters"]["peak_pages_in_use"] \
        < p["off"]["counters"]["peak_pages_in_use"]
    assert p["off"]["counters"]["prefix_hits"] == 0
    c = port["serve_cancel"]
    assert c["tokens"][0] == [] and len(c["tokens"][1]) == 4
