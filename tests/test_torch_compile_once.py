"""Port parity, the compile-once discipline: every fixed-shape program the
reference jits is a step the port builds once (a CUDA graph on the card;
on the CPU the first call, as a trace is in JAX) and counts under the
reference's counters and sanitizer labels.

On identical traffic the port's `prefill_compiles`, `paste_compiles`,
`decode_compiles` and `chunk_compiles`, and the sanitizer's builds per
label ("prefill", "paste", "decode", "chunk"), equal the JAX engine's in
the dense family's four layouts (dense bucketed and unbucketed, paged
monolithic and chunked) and for a moe, a vlm (mixed patch counts: one
prefill a (bucket, patch count)), an encdec, an ssm and a hybrid config
(exact-length prefill: one build a prompt length, one state paste). The
sharded engine's page move ("move") builds as often as the JAX sharded
engine's through a drain: the reference runs on a forced 8-device CPU
mesh in a subprocess (`tests/test_torch_migration.py`'s harness) while
the port runs the same scenario in process. The reference's hierarchy
over 18 prompt lengths (`tests/test_serve_fastpath.py`) holds, and the SoC
simulator's captured tick blocks are held bit for bit to its per-op loop
(the block's capture stands in for the card's, which runs nothing)."""

import gc
import importlib.util
import math
import os

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
from repro_torch.serve.engine import ServeEngine

# one intra-op thread a test process (xdist runs six)
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_migration_harness",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "test_torch_migration.py"))
H = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(H)

STATS = ("prefill_compiles", "paste_compiles", "decode_compiles",
         "chunk_compiles")
LABELS = ("prefill", "paste", "decode", "chunk")

# case -> (arch, engine kwargs); the traffic is `_traffic`'s
CASES = {
    "dense-bucketed": ("smollm-360m", dict(paged=False,
                                           chunked_prefill=False)),
    "dense-unbucketed": ("smollm-360m", dict(paged=False,
                                             chunked_prefill=False,
                                             bucket_prompts=False)),
    "paged-mono": ("smollm-360m", dict(page_size=16, chunked_prefill=False)),
    "paged-chunked": ("smollm-360m", dict(page_size=16)),
    "paged-mono-int8": ("smollm-360m", dict(page_size=16,
                                            chunked_prefill=False,
                                            wdtype="int8", kv_dtype="int8")),
    "moe-dense": ("qwen2-moe-a2.7b", dict(paged=False,
                                          chunked_prefill=False)),
    "vlm-paged-mono": ("llava-next-mistral-7b",
                       dict(page_size=16, chunked_prefill=False)),
    "encdec-dense": ("seamless-m4t-medium", dict(paged=False,
                                                 chunked_prefill=False)),
    "encdec-chunked": ("seamless-m4t-medium", dict(page_size=16)),
    "ssm": ("mamba2-780m", {}),
    "hybrid": ("recurrentgemma-2b", {}),
}
# (the JAX SSD takes a prompt of at most one chunk, 32 rows at smoke size)
LENS = (5, 9, 17, 9, 31, 5, 12)


@pytest.fixture(scope="module")
def models():
    """arch -> (cfg, JAX model, JAX params, port model, port params)."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg = get_config(arch).smoke()
            jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=32))
            jp = jm.init(jax.random.key(0))
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
            built[arch] = cfg, jm, jp, build_model(cfg, device="cpu"), tp
        return built[arch]
    return get


def _traffic(eng, cfg):
    """LENS's prompts, two tokens each; a vlm request in three carries
    4 or 12 patch rows (the rest none), an encdec request its frames."""
    rng = np.random.default_rng(11)
    for i, n in enumerate(LENS):
        extras = None
        if cfg.family == "vlm" and i % 3:
            extras = {"patch_embeds": rng.standard_normal(
                (4 if i % 3 == 1 else min(12, n), cfg.d_model)).astype(
                    np.float32)}
        if cfg.family == "encdec":
            extras = {"frames": rng.standard_normal(
                (cfg.cross_len, cfg.d_model)).astype(np.float32)}
        eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=2, extras=extras)
    eng.run_to_completion()


@pytest.fixture(scope="module")
def jax_counts(models):
    """case -> (JAX engine counters, its sanitizer's builds per label),
    each run once a module."""
    done = {}

    def get(case):
        if case not in done:
            arch, kw = CASES[case]
            cfg, jm, jp, _, _ = models(arch)
            eng = JaxEngine(jm, params=jp, n_slots=2, max_len=64, **kw)
            # the reference's per-label count is the live jits' cache sizes
            # before and after: an engine of another case that dies inside
            # the watch would take its entries out of the difference
            gc.collect()
            with jsanitizer.watch() as log:
                _traffic(eng, cfg)
            done[case] = ({k: getattr(eng.stats, k) for k in STATS},
                          {k: log.entry_compiles.get(k, 0) for k in LABELS})
        return done[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_builds_equal_jax_engine(models, jax_counts, case):
    """The port's build counters and per-label builds equal the JAX
    engine's traces on the same traffic; a second identical wave builds
    nothing; the summary's keys are the reference's."""
    arch, kw = CASES[case]
    cfg, _, _, tm, tp = models(arch)
    eng = ServeEngine(tm, params=tp, n_slots=2, max_len=64, device="cpu",
                      **kw)
    with sanitizer.watch() as log:
        _traffic(eng, cfg)
    stats = {k: getattr(eng.stats, k) for k in STATS}
    labels = {k: log.entry_compiles.get(k, 0) for k in LABELS}
    want_stats, want_labels = jax_counts(case)
    assert stats == want_stats, (stats, want_stats)
    assert labels == want_labels, (labels, want_labels)
    if not eng.chunked:
        assert stats["prefill_compiles"] > 0 and stats["paste_compiles"] > 0
    with sanitizer.compile_budget(total=0):
        _traffic(eng, cfg)
    je = JaxEngine(models(arch)[1], params=models(arch)[2], n_slots=1,
                   max_len=32)
    assert set(eng.stats.summary()) == set(je.stats.summary())


def test_recurrent_prefill_runs_per_op_and_its_paste_once(models):
    """The recurrent families' exact-length prefill: one build a distinct
    prompt length, never a graph (`per_op`), and one state paste."""
    cfg, _, _, tm, tp = models("mamba2-780m")
    eng = ServeEngine(tm, params=tp, n_slots=2, max_len=64, device="cpu")
    _traffic(eng, cfg)
    assert eng.steps["prefill"].per_op
    assert eng.stats.prefill_compiles == len(set(LENS))
    assert eng.stats.paste_compiles == 1


# ---------------------------------------------- the reference's hierarchy
def _prompt(seed, n, vocab=512):
    return np.asarray(jax.random.randint(jax.random.key(seed), (n,), 0,
                                         vocab), np.int32)


def test_prefill_compiles_log_in_max_len(models):
    """`tests/test_serve_fastpath.py`'s hierarchy over 18 distinct prompt
    lengths: chunked prefill builds ONE chunk step and no prefill;
    bucketed monolithic prefill at most ceil(log2 max_len) prefill and
    paste steps; unbucketed one a length."""
    _, _, _, tm, tp = models("smollm-360m")
    max_len = 64
    lengths = list(range(3, 21))
    eng = ServeEngine(tm, n_slots=2, max_len=max_len, params=tp,
                      device="cpu")
    assert eng.chunked
    for i, n in enumerate(lengths):
        eng.submit(_prompt(i, n), max_new_tokens=2)
    eng.run_to_completion()
    assert eng.stats.chunk_compiles == 1, eng.stats.summary()
    assert eng.stats.prefill_compiles == eng.stats.paste_compiles == 0
    assert eng.stats.prefills == len(lengths)
    engb = ServeEngine(tm, n_slots=2, max_len=max_len, params=tp,
                       chunked_prefill=False, device="cpu")
    for i, n in enumerate(lengths):
        engb.submit(_prompt(i, n), max_new_tokens=2)
    engb.run_to_completion()
    budget = math.ceil(math.log2(max_len))
    assert engb.stats.prefill_compiles <= budget, engb.stats.summary()
    assert engb.stats.paste_compiles == engb.stats.prefill_compiles
    eng0 = ServeEngine(tm, n_slots=2, max_len=max_len, params=tp,
                       bucket_prompts=False, chunked_prefill=False,
                       device="cpu")
    for i, n in enumerate(lengths):
        eng0.submit(_prompt(i, n), max_new_tokens=2)
    eng0.run_to_completion()
    assert eng0.stats.prefill_compiles == len(lengths)


# ------------------------------------------------------ the sharded move
def drain_moves(api):
    """A sensor-hot shard 1 drains by live page migration: the decode,
    chunk and move builds of the run (the reference's sanitizer labels)
    with its tokens and counters."""
    san = jsanitizer if api.pkg == "jax" else sanitizer
    plan = api.plan((4, "sensor_hot", 1, dict(delta_c=60.0, ticks=8)))
    eng = api.engine("smollm-360m", 4, n_slots=8, max_len=64, page_size=8,
                     n_pages=24, fault_plan=plan)
    lens = [5 + (i * 7) % 23 for i in range(5)]
    gc.collect()                 # as in `jax_counts`
    with san.watch() as log:
        reqs = [eng.submit(H.prompt(i, n), max_new_tokens=12, seed=100 + i)
                for i, n in enumerate(lens)]
        eng.run_to_completion()
    return H.summary(eng, reqs, move_builds=log.entry_compiles.get("move"),
                     compiles=[eng.stats.decode_compiles,
                               eng.stats.chunk_compiles])


SCENARIOS = dict(drain_moves=drain_moves)


@pytest.fixture(scope="module")
def reference():
    res = H.JaxResults(os.path.abspath(__file__))
    yield res
    res.close()


def test_sharded_move_builds_equal_jax_engine(reference):
    got = H.run_scenarios(H.Api("torch"), SCENARIOS)["drain_moves"]
    want = reference.get()["drain_moves"]
    H.assert_same(got, want, "drain_moves")
    assert got["counters"]["migrated_pages"] > 0
    assert got["move_builds"] == want["move_builds"] == 1


# -------------------------------------------- the SoC simulator's blocks
@pytest.mark.parametrize("duration_ms", [0.5, 2.2, 5.6])
def test_soc_tick_blocks_equal_per_op_loop(monkeypatch, duration_ms):
    """The card's tick loop (a per-op lead, then replays of one captured
    block of TICK_BLOCK ticks over static carry tensors) on the CPU, the
    capture replaced by a function that replays the block's ops: every
    metric bit-equal to the per-op loop, at tick counts that fill their
    last block and that do not."""
    from repro_torch.core import soc as tsoc
    from repro_torch.core.scenarios import SCENARIO_ORDER
    from repro_torch.core.scenarios import SCENARIOS as SOCS
    from repro_torch.core.workloads import MOBILENET_V2
    socs = [tsoc.hot_variant(tsoc.build_soc(SOCS[s]))
            for s in SCENARIO_ORDER]
    rates = torch.linspace(25.0, 1500.0, 5)
    want = tsoc.simulate_batch(socs, MOBILENET_V2, rates,
                               duration_ms=duration_ms, device="cpu")
    captured = []
    monkeypatch.setattr(tsoc, "TICK_BLOCK", 7)
    monkeypatch.setattr(tsoc, "_captures", lambda device, eager: not eager)
    monkeypatch.setattr(tsoc, "_capture",
                        lambda block: captured.append(block) or block)
    got = tsoc.simulate_batch(socs, MOBILENET_V2, rates,
                              duration_ms=duration_ms, device="cpu")
    assert len(captured) == (1 if round(duration_ms * 10) > 7 else 0)
    eager = tsoc.simulate_batch(socs, MOBILENET_V2, rates,
                                duration_ms=duration_ms, device="cpu",
                                eager=True)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(eager[k], want[k]), k
