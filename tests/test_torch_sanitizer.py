"""The port's capture / host-sync sanitizer (`repro_torch.analysis.sanitizer`)
against the cases the reference's runs (`tests/test_contracts.py`, "runtime
sanitizer" and "engine-level steady state"), with `serve/graphs.StepGraph`
steps in place of jitted functions: a step's build is its compile. On the
CPU a step builds on its first call (on the card it captures its CUDA
graph there). The engine cases also hold the port's counters to the JAX
engine's on the same waves."""

import jax
import numpy as np
import pytest
import torch

from repro.analysis import sanitizer as jsanitizer
from repro.configs import get_config
from repro.models import ExecOptions, build_model as jbuild
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.analysis import sanitizer
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import EngineStats, ServeEngine
from repro_torch.serve.graphs import StepGraph

# one intra-op thread a test process (xdist runs six)
torch.set_num_threads(1)


class _Owner:
    """The least an engine offers a step: stats with the counter."""

    def __init__(self):
        self.stats = EngineStats()
        self.w = torch.arange(4, dtype=torch.float32)


def _step(owner, n=4, label="g_test"):
    return StepGraph(owner, lambda o, inp: inp["x"] * 2 + o.w[:n],
                     {"x": ((n,), torch.float32)}, state=lambda o: [o.w],
                     stat="decode_compiles", label=label, device="cpu",
                     eager=False)


def test_watch_counts_fresh_build_then_cached():
    owner = _Owner()
    f = _step(owner)
    with sanitizer.watch() as log:
        f(x=np.ones(4, np.float32))
    assert log.compiles == 1
    with sanitizer.watch() as log2:
        f(x=np.ones(4, np.float32))
    assert log2.compiles == 0
    assert owner.stats.decode_compiles == 1


def test_watch_counts_explicit_host_syncs():
    x = torch.arange(4)
    with sanitizer.watch() as log:
        x.cpu().numpy()            # one conversion, chained: counts once
        x[1].item()
        x.tolist()
        np.asarray(np.zeros(3))    # numpy->numpy: NOT a sync
    assert log.host_syncs == 3


def test_nested_watches_both_count():
    x = torch.arange(4)
    with sanitizer.watch() as outer:
        x.tolist()
        with sanitizer.watch() as inner:
            x.numpy()
    assert (outer.host_syncs, inner.host_syncs) == (2, 1)
    x.tolist()                     # outside every watch: the patch is gone
    assert outer.host_syncs == 2


def test_entry_point_attribution():
    owner = _Owner()
    with sanitizer.watch() as log:
        _step(owner, 4)(x=np.ones(4, np.float32))
        _step(owner, 2)(x=np.ones(2, np.float32))    # a second shape
    assert log.entry_compiles["g_test"] == 2
    assert "g_test_compiles" in log.summary()


def test_register_rejects_plain_callable():
    with pytest.raises(TypeError):
        sanitizer.register_entry_point("nope", lambda x: x)
    with pytest.raises(TypeError):
        jsanitizer.register_entry_point("nope", lambda x: x)


def test_compile_budget_enforced():
    owner = _Owner()
    with sanitizer.compile_budget(h_test=2):
        _step(owner, label="h_test")(x=np.ones(4, np.float32))
    with pytest.raises(sanitizer.CompileBudgetExceeded, match="h_test"):
        with sanitizer.compile_budget(h_test=0):
            _step(owner, 3, label="h_test")(x=np.ones(3, np.float32))


def test_compile_budget_unknown_label():
    with pytest.raises(ValueError, match="not_registered"):
        with sanitizer.compile_budget(not_registered=1):
            pass


def test_compile_budget_total_and_syncs():
    owner = _Owner()
    with pytest.raises(sanitizer.CompileBudgetExceeded, match="host_syncs"):
        with sanitizer.compile_budget(host_syncs=0):
            _step(owner)(x=np.ones(4, np.float32)).tolist()
    with pytest.raises(sanitizer.CompileBudgetExceeded, match="total"):
        with sanitizer.compile_budget(total=0):
            _step(owner)(x=np.ones(4, np.float32))


def test_entry_counts_survive_dead_steps():
    """A step that dies inside the region still counted its build; the
    live sum (`entry_cache_sizes`) drops it, as the reference's does."""
    owner = _Owner()
    with sanitizer.watch() as log:
        f = _step(owner, label="dead_test")
        f(x=np.ones(4, np.float32))
        del f
    assert log.entry_compiles["dead_test"] == 1
    assert sanitizer.entry_cache_sizes()["dead_test"] == 0


# --------------------------------------------------------------------------
# engine-level steady state, against the JAX engine's counters


@pytest.fixture(scope="module")
def smol():
    cfg = get_config("smollm-360m").smoke()
    jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=32))
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, jp, build_model(cfg, device="cpu"), tp


def _wave(eng, cfg, n=4, sample=False):
    rng = np.random.default_rng(3)
    for i in range(n):
        eng.submit(np.asarray(rng.integers(0, cfg.vocab_size, 6 + 5 * i),
                              np.int32), max_new_tokens=4, seed=i,
                   sample_params=(0.8, 20, 0.9) if sample and i == 2
                   else None)
    return eng.run_to_completion()


@pytest.mark.parametrize("layout", [
    dict(page_size=16),
    dict(page_size=16, chunked_prefill=False),
    dict(paged=False, chunked_prefill=False)])
def test_engine_meets_declared_compile_budgets(smol, layout):
    """A first full wave stays inside COMPILE_BUDGETS with the JAX engine's
    counts, an identical second wave builds NOTHING (the steady-state gate
    as a unit test), and every decode tick makes exactly one host sync."""
    cfg, jm, jp, tm, tp = smol
    kw = dict(n_slots=2, max_len=64, **layout)
    eng = ServeEngine(tm, params=tp, device="cpu", **kw)
    je = JaxEngine(jm, params=jp, **kw)
    with sanitizer.compile_budget(**ServeEngine.COMPILE_BUDGETS):
        _wave(eng, cfg)
    with jsanitizer.compile_budget(**JaxEngine.COMPILE_BUDGETS):
        _wave(je, cfg)
    steps = eng.stats.decode_steps
    with sanitizer.compile_budget(total=0) as log:
        _wave(eng, cfg)
    assert log.host_syncs == eng.stats.decode_steps - steps > 0
    _wave(je, cfg)
    for name in ("decode_compiles", "chunk_compiles", "decode_steps"):
        assert getattr(eng.stats, name) == getattr(je.stats, name), name
    assert eng.stats.chunk_compiles == (1 if eng.chunked else 0)


# every family the engine serves with a chunk step, in every layout of the
# dense family (the recurrent families' sampled counters are held in
# tests/test_torch_ssm.py and tests/test_torch_hybrid.py)
FAMILIES = {
    "dense-paged": ("smollm-360m", dict(page_size=16)),
    "dense-paged-mono": ("smollm-360m", dict(page_size=16,
                                             chunked_prefill=False)),
    "dense-dense": ("smollm-360m", dict(paged=False, chunked_prefill=False)),
    "moe": ("qwen2-moe-a2.7b", dict(page_size=16)),
    "mla": ("deepseek-v2-lite", dict(page_size=16)),
    "vlm": ("llava-next-mistral-7b", dict(page_size=16)),
    "encdec": ("seamless-m4t-medium", dict(page_size=16)),
}


@pytest.fixture(scope="module")
def pairs(smol):
    """arch -> (cfg, JAX model, JAX params, port model, port params)."""
    done = {"smollm-360m": smol}

    def get(arch):
        if arch not in done:
            cfg = get_config(arch).smoke()
            jm = jbuild(cfg, ExecOptions(attn_impl="reference"))
            jp = jm.init(jax.random.key(0))
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
            done[arch] = cfg, jm, jp, build_model(cfg, device="cpu"), tp
        return done[arch]
    return get


def _sampled_wave(eng, cfg):
    """Four requests, the third sampled: the sampled decode step is built
    on its first tick, the greedy one on ticks without it."""
    rng = np.random.default_rng(3)
    for i in range(4):
        extras = None
        if cfg.family == "encdec":
            extras = {"frames": rng.standard_normal(
                (cfg.cross_len, cfg.d_model)).astype(np.float32)}
        eng.submit(rng.integers(0, cfg.vocab_size, 6 + 5 * i).astype(
            np.int32), max_new_tokens=4, seed=i, extras=extras,
            sample_params=(0.8, 20, 0.9) if i == 2 else None)
    return eng.run_to_completion()


@pytest.mark.parametrize("case", list(FAMILIES))
def test_sampled_wave_counters_equal_jax_engine(pairs, case):
    """One sampled request builds the sampled step lazily: decode and chunk
    counts equal the JAX engine's traces on the same traffic, within
    COMPILE_BUDGETS; a warm second wave builds nothing."""
    arch, layout = FAMILIES[case]
    cfg, jm, jp, tm, tp = pairs(arch)
    kw = dict(n_slots=2, max_len=64, **layout)
    eng = ServeEngine(tm, params=tp, device="cpu", **kw)
    je = JaxEngine(jm, params=jp, **kw)
    with sanitizer.compile_budget(**ServeEngine.COMPILE_BUDGETS):
        _sampled_wave(eng, cfg)
    _sampled_wave(je, cfg)
    for name in ("decode_compiles", "chunk_compiles"):
        assert getattr(eng.stats, name) == getattr(je.stats, name), name
    assert eng.stats.decode_compiles == 2
    with sanitizer.compile_budget(total=0):
        _sampled_wave(eng, cfg)
