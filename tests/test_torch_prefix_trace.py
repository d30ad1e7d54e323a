"""Port parity, the reference's prefix trace (`benchmarks/run.py`, prefix
cache section) on the port for its three legs, the dense, moe and mla
(deepseek-v2-lite, one latent pool) smoke models x {f32, bf16, int8} KV:
divergence 0 against the cache-off twin, the JAX engine's counters, its
tokens (bf16 pools: up to a rounding near-tie, see
`test_reference_prefix_trace`), and for the dense f32 leg the four det
values of `BENCH_serve.json`. Split from `tests/test_torch_prefix_cache.py`,
whose helpers it shares, so that `--dist loadfile` can balance the two."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.models import common as tcommon, transformer as ttransformer
from repro_torch.serve.engine import ServeEngine
from test_torch_prefix_cache import STATS, _pair

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smol():
    return _pair("smollm-360m")


def _prefix_trace(eng, vocab):
    """`benchmarks/run.py`'s prefix trace: a 48-token system prompt from
    default_rng(11), a warm-up, then a wave of 4 requests that share it,
    odd ones sampled at (0.8, 40, 0.95)."""
    rngp = np.random.default_rng(11)
    sysp = np.asarray(rngp.integers(0, vocab, 48), np.int32)
    reqs = [eng.submit(sysp, max_new_tokens=2)]
    eng.run_to_completion()
    for i in range(4):
        tail = np.asarray(rngp.integers(0, vocab, 4 + 3 * i), np.int32)
        sp = (0.8, 40, 0.95) if i % 2 else None
        reqs.append(eng.submit(np.concatenate([sysp, tail]),
                               max_new_tokens=6, sample_params=sp,
                               seed=50 + i))
    eng.run_to_completion()
    eng.assert_accounting()
    ttft = sum(r.first_token_tick - r.submit_tick for r in reqs[1:])
    return [r.out_tokens for r in reqs], ttft, eng.stats, reqs


@pytest.fixture(scope="module")
def qmoe():
    return _pair("qwen2-moe-a2.7b")


@pytest.fixture(scope="module")
def mla():
    """The trace's mla leg as `bench_serve` builds it (moe group 32)."""
    return _pair("deepseek-v2-lite", moe_group=32)


class _JaxLogitSpy:
    """Record every row the JAX engine's sampled decode samples from,
    keyed by (tick, seed, counter): the reference's `_decode_sample` jit
    calls `sample_tokens` on its f32 logits, so wrapping the module's name
    captures them without changing what it computes. The tick tells a live
    request's row from a slot's that is still in prefill or retired, which
    carries the same seed and counter."""

    def __init__(self, monkeypatch):
        import repro.serve.engine as jax_engine
        self.rows, self.engine, inner = {}, None, jax_engine.sample_tokens

        def spy(logits, temperature, top_k, top_p, seed, counter):
            jax.debug.callback(self._record, logits, seed, counter)
            return inner(logits, temperature, top_k, top_p, seed, counter)

        monkeypatch.setattr(jax_engine, "sample_tokens", spy)

    def _record(self, logits, seed, counter):
        for b in range(logits.shape[0]):
            key = (self.engine._tick, int(seed[b]), int(counter[b]))
            self.rows[key] = np.array(logits[b])

    def watch(self, engine):
        self.rows, self.engine = {}, engine
        return engine

    def row(self, r, step):
        """The JAX engine's logits for request `r`'s token `step`, or None
        where the engine took its greedy decode."""
        return self.rows.get((r.first_token_tick + step, r.seed, step))


def _f32_sum_norm(x, weight, *, eps=1e-6, plus_one=False):
    """`rms_norm` with the reference's f32 mean of squares."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    w = 1.0 + weight.float() if plus_one else weight.float()
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def _check_bf16_partings(got, want, spy, first_tick_only):
    """Hold a bf16-pool leg's streams to the JAX engine's up to where they
    part, and each parting to a near-tie that a logit difference below
    0.05 flips. Up to and at its parting, every row the JAX engine sampled
    from lies within 0.05 of the port's kept row. A greedy parting is a
    top-1 margin under 1e-3 in the port's row. A sampled parting is a
    swap in the descending order of the kept ranks, where the sampler adds
    its Gumbel noise by rank: the two frameworks order those logits apart.
    With `first_tick_only` (moe: a parting changes the next tick's
    expert groups for every slot) only the partings at the earliest
    parting tick are held, and every stream is equal before it."""
    parts = []
    for i, (a, b) in enumerate(zip(got, want)):
        t = next((t for t, (x, y) in enumerate(zip(a.out_tokens,
                                                    b.out_tokens))
                  if x != y), None)
        if t is not None:
            parts.append((a.first_token_tick + t, i, t))
    if not parts:
        return
    first = min(parts)[0]
    held = [p for p in parts if p[0] == first] if first_tick_only else parts
    for _, i, t in held:
        a, b = got[i], want[i]
        for s in range(t + 1):
            row = spy.row(b, s)
            if row is None:             # a greedy batch: no sampled decode
                assert a.temperature <= 0, (i, s)
                continue
            assert np.abs(row - a.logits[s].numpy()).max() < 0.05, (i, s)
        mine = a.logits[t].numpy()
        if a.temperature <= 0:
            margin = mine[a.out_tokens[t]] - mine[b.out_tokens[t]]
            assert 0 <= margin < 1e-3, (i, t, margin)
        else:
            theirs = spy.row(b, t)
            order_p = np.argsort(-mine, kind="stable")
            order_j = np.argsort(-theirs, kind="stable")
            kept = max(int(np.flatnonzero(order_p == a.out_tokens[t])[0]),
                       int(np.flatnonzero(order_j == b.out_tokens[t])[0]))
            assert (order_p[:kept + 1] != order_j[:kept + 1]).any(), (i, t)


@pytest.mark.parametrize("kvd", [None, "bf16", "int8"])
@pytest.mark.parametrize("arch", ["dense", "moe", "mla"])
def test_reference_prefix_trace(request, smol, monkeypatch, arch, kvd):
    """Divergence 0 between the port's cache-on and cache-off engines, and
    the JAX engine's counters and ticks. Tokens equal the JAX engine's in
    the f32 and int8 legs. A bf16 pool rounds f32 K/V rows that differ in
    their last bits between the frameworks to 8-bit mantissas, so an
    element can land one bf16 ulp apart and a logit moves by up to ~0.02.
    There the streams are held equal up to each parting, and each parting
    to a near-tie (`_check_bf16_partings`). The port's norm (an f64 sum
    without autograd) is not the cause: with the reference's f32 sum the
    port emits the same streams. The mla leg's single latent pool runs
    through the same page registry, COW and write mask. On the CPU its
    attention is the plain path, which rounds
    the probabilities to a bf16 pool's dtype before PV as JAX's does
    (`rounded_probs`): its tokens equal the JAX engine's in every leg,
    bf16 too."""
    pair = smol if arch == "dense" else request.getfixturevalue(
        "qmoe" if arch == "moe" else "mla")
    cfg, jm, jp, tm, tp = pair
    partings = kvd == "bf16" and arch != "mla"
    spy = _JaxLogitSpy(monkeypatch) if partings else None
    legs = {}
    for cached in (True, False):
        kw = dict(n_slots=4, max_len=96, page_size=8, chunk_pages=1,
                  kv_dtype=kvd, prefix_cache=cached)
        jeng = JaxEngine(jm, params=jp, **kw)
        want = _prefix_trace(spy.watch(jeng) if spy else jeng, cfg.vocab_size)
        eng = ServeEngine(tm, params=tp, device="cpu", keep_logits=True, **kw)
        got = _prefix_trace(eng, cfg.vocab_size)
        if partings:
            _check_bf16_partings(got[3], want[3], spy,
                                 first_tick_only=arch != "dense")
            with monkeypatch.context() as mp:
                for mod in (tcommon, ttransformer):
                    mp.setattr(mod, "rms_norm", _f32_sum_norm)
                f32_sum = _prefix_trace(
                    ServeEngine(tm, params=tp, device="cpu", **kw),
                    cfg.vocab_size)
            assert f32_sum[0] == got[0], (arch, cached)
        else:
            assert got[0] == want[0], (arch, kvd, cached)
        assert got[1] == want[1]
        for name in STATS:
            assert getattr(got[2], name) == getattr(want[2], name), name
        legs[cached] = got
    assert legs[True][0] == legs[False][0]          # divergence 0
    if arch == "dense" and kvd is None:
        with open(os.path.join(REPO, "BENCH_serve.json")) as f:
            bench = json.load(f)
        st = legs[True][2]
        det = {"prefix_hit_tokens": float(st.prefix_hit_tokens),
               "prefix_cow_copies": float(st.cow_copies),
               "prefix_pool_pages_ratio": (legs[True][2].peak_pages_in_use
                                           / legs[False][2].peak_pages_in_use),
               "cache_hit_ttft_ratio": legs[True][1] / legs[False][1],
               "prefix_token_divergence": 0.0}
        for key, val in det.items():
            assert val == bench[key], (key, val, bench[key])
