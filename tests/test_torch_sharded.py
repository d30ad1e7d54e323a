"""Port parity, sharded serving: the port's `ShardedServeEngine`
(`serve/sharded.py`; slots and a paged pool split into shards on one
device, one global decode step a tick) against the JAX package.

  * Tokens, in process: at 1, 2, 4 and 8 shards the port's sharded engine
    gives the JAX single-host `ServeEngine`'s tokens (which the reference
    pins equal to its own sharded engine's) for dense (smollm-360m), moe
    (qwen2-moe-a2.7b), MLA (deepseek-v2-lite) and vlm
    (llava-next-mistral-7b) `.smoke()`, in f32, with int8 KV and with int8
    weights and KV, and for dense also seeded sampling, a window of 16 and
    the prefix cache; a mid-prefill cancel leaves its neighbour's stream
    and the pool whole.
  * Counters at one shard: `tests/test_sharded_serve.py:163`,
    `tests/test_chaos.py:240` and `tests/test_prefix_cache.py:319` run the
    JAX one-shard engine and the port in process (the 8-shard cases are
    `tests/test_torch_sharded_counters.py`).
  * A DEAD shard's bytes stay readable on one card, so a replay that read
    them would go unseen: the poison control overwrites a shard's whole
    page range the tick it dies (NaN in float pools, 127 in int8 rows with
    NaN scales) and every stream must stay unchanged; the same poison on a
    live shard must change one (it reaches the streams).
  * The constructor's checks, the locality check, and the CLI's
    `--shards`.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch.mesh import make_serve_mesh as jmesh
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.sharded import ShardedServeEngine as JaxSharded

from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models.registry import build_model
from repro_torch.serve.faults import FaultEvent, FaultPlan
from repro_torch.serve.health import Health
from repro_torch.serve.sharded import ShardedServeEngine

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

MAX_LEN, PAGE, SLOTS = 64, 8, 8
SHARDS = (1, 2, 4, 8)
INT8 = {"wdtype": "int8", "kv_dtype": "int8"}
# patch rows at the embedding table's row scale (tests/test_torch_vlm.py)
PATCH_STD = 0.02


def _patches(seed, n, d):
    return (PATCH_STD * np.random.default_rng(seed).standard_normal((n, d))
            ).astype(np.float32)


def _traffic(kind, cfg):
    """Phases of submissions (prompt, max_new, extras, sample, seed); each
    phase is served to completion before the next is submitted."""
    if kind == "mixed":       # short budgets retire mid-stream
        return [[(prompt(i, n), m, None, None, 100 + i) for i, (n, m) in
                 enumerate(zip([9, 17, 6, 23, 13, 31], [2, 8, 4, 1, 6, 3]))]]
    if kind == "short":
        return [[(prompt(i, n), 4, None, None, 100 + i)
                 for i, n in enumerate([9, 17, 6, 23])]]
    if kind == "sampled":
        return [[(prompt(i, n), 6, None, (0.8, 20, 0.9), 100 + i)
                 for i, n in enumerate([9, 17, 6, 23])]]
    if kind == "window":      # prompts longer than the window
        return [[(prompt(i, n), 8, None, None, 100 + i)
                 for i, n in enumerate([40, 30, 21])]]
    if kind == "moe":
        return [[(prompt(i, n), 3, None, None, 100 + i)
                 for i, n in enumerate([9, 17, 12])]]
    if kind == "prefix":      # warm-up, a shared-prefix wave, a full hit
        sysp = prompt(7, 24)
        wave = [(np.concatenate([sysp, prompt(100 + i, 5 + i)]), 6, None,
                 None, 50 + i) for i in range(4)]
        wave.append((prompt(40, 5), 6, None, None, 0))
        return [[(sysp, 4, None, None, 0)], wave,
                [(sysp.copy(), 4, None, None, 0)]]
    if kind == "vlm":         # patch rows split the 16-row chunk and page
        rng = np.random.default_rng(5)
        out = []
        for i, (n, p) in enumerate([(17, 8), (24, 12), (30, 19), (20, 0),
                                    (12, 12), (26, 5)]):
            x = {"patch_embeds": _patches(100 + i, p, cfg.d_model)} \
                if p else None
            out.append((rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                        4, x, None, 100 + i))
        return [out]
    raise ValueError(kind)


# name: (arch, init key, window, engine kwargs, traffic)
CASES = {
    "dense_f32": ("smollm-360m", 1, None, {}, "mixed"),
    "dense_int8kv": ("smollm-360m", 1, None, {"kv_dtype": "int8"}, "short"),
    "dense_int8": ("smollm-360m", 1, None, INT8, "short"),
    "dense_sampled": ("smollm-360m", 1, None, {}, "sampled"),
    "dense_window16": ("smollm-360m", 2, 16, {}, "window"),
    "dense_prefix": ("smollm-360m", 1, None, {"prefix_cache": True},
                     "prefix"),
    "moe_f32": ("qwen2-moe-a2.7b", 3, None, {}, "moe"),
    "moe_int8": ("qwen2-moe-a2.7b", 3, None, INT8, "moe"),
    "mla_f32": ("deepseek-v2-lite", 1, None, {}, "moe"),
    "mla_int8": ("deepseek-v2-lite", 1, None, INT8, "moe"),
    "vlm_f32": ("llava-next-mistral-7b", 1, None, {}, "vlm"),
    "vlm_int8": ("llava-next-mistral-7b", 1, None, INT8, "vlm"),
}


def _serve(eng, phases):
    reqs = []
    for phase in phases:
        reqs += [eng.submit(p, max_new_tokens=m, extras=x, sample_params=s,
                            seed=sd) for p, m, x, s, sd in phase]
        eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [list(map(int, r.out_tokens)) for r in reqs]


@pytest.fixture(scope="module")
def apis():
    return Api("jax"), Api("torch")


@pytest.fixture(scope="module")
def jax_tokens(apis):
    """case -> the JAX single-host engine's tokens, computed once."""
    done = {}

    def get(case):
        if case not in done:
            arch, key, window, kw, traffic = CASES[case]
            jm, jp = apis[0].build(arch, key, window)
            eng = JaxEngine(jm, n_slots=SLOTS, max_len=MAX_LEN, params=jp,
                            page_size=PAGE, **kw)
            done[case] = _serve(eng, _traffic(traffic, jm.cfg))
        return done[case]
    return get


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tokens_equal_jax_engine(case, shards, apis, jax_tokens):
    arch, key, window, kw, traffic = CASES[case]
    eng = apis[1].engine(arch, shards, key, window, n_slots=SLOTS,
                         max_len=MAX_LEN, page_size=PAGE, **kw)
    got = _serve(eng, _traffic(traffic, eng.cfg))
    assert got == jax_tokens(case)
    eng.assert_local_page_tables()
    eng.assert_pool_accounting()
    assert eng.stats.pages_in_use == 0
    assert all(s.allocatable() == eng.n_pages - 1 for s in eng._sched.shards)
    if window:
        assert eng.stats.peak_pages_in_use \
            <= SLOTS * eng._sched._window_pages()
    if traffic == "prefix" and shards < 8:
        assert eng.stats.prefix_hits >= 3 and eng.stats.cow_copies >= 1


def test_mid_prefill_cancel_keeps_the_survivor(apis):
    """A long prompt cancelled mid-prefill drains its chunk queue and
    frees its pages; the survivor's stream is the JAX engine's."""
    eng = apis[1].engine("smollm-360m", 8, n_slots=8, max_len=64,
                         page_size=8)
    r_long = eng.submit(prompt(0, 40), max_new_tokens=4)
    r_short = eng.submit(prompt(1, 9), max_new_tokens=4)
    eng.step()                       # admits; the long prompt's first chunk
    assert eng._sched.find(r_long) is not None
    eng.cancel(r_long)
    eng.run_to_completion()
    eng.assert_local_page_tables()
    assert eng.stats.pages_in_use == 0
    assert all(s.allocatable() == eng.n_pages - 1 for s in eng._sched.shards)
    jm, jp = apis[0].build("smollm-360m")
    single = JaxEngine(jm, n_slots=2, max_len=64, params=jp, page_size=8)
    s_short = single.submit(prompt(1, 9), max_new_tokens=4)
    single.run_to_completion()
    assert r_short.out_tokens == s_short.out_tokens
    assert r_long.done and r_long.out_tokens == []


# ------------------------------------------------ one shard, both in process
def _same_counters(te, je, names=H.COUNTERS):
    for k in names:
        assert getattr(te.stats, k) == getattr(je.stats, k), k
    assert te.shard_summary() == je.shard_summary()


def test_one_shard_degenerates_to_the_single_host(apis):
    """`tests/test_sharded_serve.py:163`: one shard, tokens and counters
    of the JAX one-shard sharded engine (and its single-host tokens)."""
    jm, jp = apis[0].build("smollm-360m")
    runs = []
    for eng in (JaxSharded(jm, mesh=jmesh(1), n_slots=2, max_len=64,
                           params=jp, page_size=8),
                apis[1].engine("smollm-360m", 1, n_slots=2, max_len=64,
                               page_size=8)):
        reqs = [eng.submit(prompt(i, n), max_new_tokens=4)
                for i, n in enumerate((9, 17, 6))]
        eng.run_to_completion()
        eng.assert_local_page_tables()
        runs.append((eng, [r.out_tokens for r in reqs]))
    (je, jt), (te, tt) = runs
    assert tt == jt
    _same_counters(te, je)
    assert te.shard_tokens == [12] and te.stats.pages_in_use == 0


def test_pool_exhaustion_queues_fifo(apis):
    """`tests/test_chaos.py:240`: each request reserves 2 pages of a
    3-page pool, so one at a time runs and the queue drains FIFO."""
    jm, jp = apis[0].build("smollm-360m", key=0)
    runs = []
    for eng in (JaxSharded(jm, mesh=jmesh(1), n_slots=4, max_len=64,
                           params=jp, page_size=8, n_pages=4),
                apis[1].engine("smollm-360m", 1, key=0, n_slots=4,
                               max_len=64, page_size=8, n_pages=4)):
        reqs = [eng.submit(prompt(i, 12), max_new_tokens=4, seed=100 + i)
                for i in range(4)]
        finished = []
        for _ in range(400):
            live = eng.step()
            finished += [r.rid for r in reqs
                         if r.done and r.rid not in finished]
            if not live:
                break
        assert all(r.done and not r.timed_out for r in reqs)
        assert finished == sorted(finished)
        eng.assert_pool_accounting()
        eng.assert_local_page_tables()
        runs.append((eng, [r.out_tokens for r in reqs]))
    (je, jt), (te, tt) = runs
    assert tt == jt and all(len(t) == 4 for t in tt)
    _same_counters(te, je)


def test_prefix_cache_one_shard_parity(apis):
    """`tests/test_prefix_cache.py:319`: a one-shard cached engine equals
    the single-host cached engine: placement, COW, full hits and all."""
    jm, jp = apis[0].build("smollm-360m", key=0)
    sysp = prompt(23, 32)

    def run(eng):
        warm = eng.submit(sysp, max_new_tokens=4)
        eng.run_to_completion()
        wave = [eng.submit(np.concatenate([sysp, prompt(100 + i, 4 + 3 * i)]),
                           max_new_tokens=6, seed=50 + i) for i in range(4)]
        eng.run_to_completion()
        dup = eng.submit(sysp.copy(), max_new_tokens=4)   # a full hit
        eng.run_to_completion()
        return [list(r.out_tokens) for r in [warm] + wave + [dup]]

    single = JaxEngine(jm, n_slots=4, max_len=96, params=jp, page_size=8,
                       chunk_pages=1, prefix_cache=True)
    want = run(single)
    eng = apis[1].engine("smollm-360m", 1, key=0, n_slots=4, max_len=96,
                         page_size=8, chunk_pages=1, prefix_cache=True)
    assert run(eng) == want
    assert eng.stats.prefix_hits == single.stats.prefix_hits
    assert eng.stats.cow_copies == single.stats.cow_copies >= 1
    eng.assert_pool_accounting()
    eng.assert_local_page_tables()


# ------------------------------------------------------ dead-shard poison
def _poisoned(eng, pred):
    """Wrap the engine's fault step: right after a tick's events, each
    shard for which `pred(eng, shard)` first holds has its whole page
    range overwritten (NaN in float pools; 127 in int8 rows, NaN
    scales)."""
    orig, hit = eng._apply_faults, set()

    def apply_faults():
        orig()
        for s in range(eng.n_shards):
            if s in hit or not pred(eng, s):
                continue
            hit.add(s)
            lo, hi = s * eng.n_pages, (s + 1) * eng.n_pages
            for pool in eng._pools.values():
                pool[:, lo:hi] = 127 if pool.dtype == torch.int8 \
                    else float("nan")
    eng._apply_faults = apply_faults
    return hit


def _dead(eng, s):
    return eng._monitor.state[s] == Health.DEAD


def _plan(kind, tick=6, shard=2):
    return FaultPlan(events=(FaultEvent(tick=tick, kind=kind, shard=shard,
                                        delta_c=0.0, ticks=1),))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_poisoned_dead_shard_changes_no_stream(apis, kv):
    def run(plan=None, pred=None):
        eng = apis[1].engine("smollm-360m", 4, n_slots=8, max_len=64,
                             page_size=8, kv_dtype=kv, fault_plan=plan)
        hit = _poisoned(eng, pred) if pred else set()
        reqs = [eng.submit(prompt(i, 7 + 3 * i), max_new_tokens=12,
                           seed=100 + i) for i in range(8)]
        eng.run_to_completion()
        eng.assert_pool_accounting()
        return eng, hit, [r.out_tokens for r in reqs]

    _, _, free = run()
    eng, hit, toks = run(_plan("shard_death"), _dead)
    assert hit == {2} and eng.stats.recoveries >= 1
    assert toks == free
    # the negative control: the same poison on a live shard, which the
    # fault plan only heats for a tick, reaches its streams
    _, hit, toks = run(_plan("sensor_hot"),
                       lambda e, s: s == 2 and e._tick >= 6)
    assert hit == {2} and toks != free


# ------------------------------------------------------------- validation
def test_validation(apis):
    """`tests/test_sharded_serve.py:191` and the port's own refusals."""
    mesh = make_serve_mesh(1, device="cpu")
    model, params = apis[1].build("smollm-360m", key=0)
    with pytest.raises(ValueError):          # pages must tile max_len
        ShardedServeEngine(model, mesh=mesh, n_slots=2, max_len=60,
                           params=params, page_size=8)
    with pytest.raises(ValueError):          # unknown mesh axis
        ShardedServeEngine(model, mesh=mesh, axis="model", params=params)
    with pytest.raises(ValueError):          # slots must divide
        ShardedServeEngine(model, mesh=make_serve_mesh(3, device="cpu"),
                           n_slots=4, params=params)
    with pytest.raises(ValueError):          # the pool is paged
        ShardedServeEngine(model, mesh=mesh, params=params, kv_dtype="fp8")
    with pytest.raises(ValueError):
        ShardedServeEngine(model, mesh=mesh, params=None)
    for arch in ("mamba2-780m", "recurrentgemma-2b", "seamless-m4t-medium"):
        cfg = get_config(arch).smoke()
        m = build_model(cfg, device="cpu")
        with pytest.raises(ValueError):      # recurrent and encdec refused
            ShardedServeEngine(m, mesh=mesh, params=m.init(0))
    eng = ShardedServeEngine(model, mesh=mesh, n_slots=2, max_len=64,
                             params=params, page_size=8)
    with pytest.raises(ValueError):
        eng.submit(np.zeros((2, 3), np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.zeros((65,), np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.zeros((4,), np.int32), extras={"frames": np.zeros(3)})
    with pytest.raises(ValueError):
        make_serve_mesh(0, device="cpu")


def test_locality_check_sees_a_foreign_page(apis):
    """`assert_local_page_tables` fails on a page id past the shard's
    range, and the translated table keeps each row in its shard."""
    eng = apis[1].engine("smollm-360m", 4, n_slots=8, max_len=64,
                         page_size=8)
    eng.submit(prompt(0, 20), max_new_tokens=8)
    for _ in range(4):
        eng.step()
    eng.assert_local_page_tables()
    g = next(g for g in range(8) if eng._active[g])
    table = eng.global_page_table()
    s = g // eng.slots_per_shard
    assert (table[g] >= s * eng.n_pages).all()
    assert (table[g] < (s + 1) * eng.n_pages).all()
    eng._page_table[g, 0] = eng.n_pages
    with pytest.raises(AssertionError):
        eng.assert_local_page_tables()


@pytest.mark.parametrize("extra", [[], ["--fault-seed", "0"]])
def test_serve_cli_shards_on_cpu(capsys, extra):
    stats = serve_cli.main(
        ["--smoke", "--device", "cpu", "--requests", "8", "--slots", "6",
         "--max-len", "64", "--new-tokens", "4", "--shards", "4",
         "--page-size", "8"] + extra)
    out = capsys.readouterr().out
    assert "rounding slots to 4 (4 shards)" in out
    assert "shards=4  tokens/shard=" in out and "migrations=" in out
    assert stats.tokens_out == 32
    if extra:
        assert "shard health:" in out and "recoveries=" in out
    for bad in (["--page-size", "0"], ["--no-chunked-prefill"]):
        with pytest.raises(SystemExit):
            serve_cli.main(["--smoke", "--device", "cpu", "--shards", "2"]
                           + bad)
