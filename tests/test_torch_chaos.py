"""Port parity, single-host fault tolerance: `repro_torch.serve.faults`,
`repro_torch.serve.health` and the engine's queue cap, TTLs, page
squeezes, pools below the worst case and preemption, against the JAX
package's (`tests/test_chaos.py`'s single-host cases and
`tests/test_prefix_cache.py::test_squeeze_steals_cached_pages_with_parity`).

A seeded chaos plan is the same data in both packages; the health
machine walks the same transitions on the same occupancy and sensor
sequence; and every engine case runs the JAX engine and the port on the
same bridged weights (smollm-360m `.smoke()`, f32) and asserts equal
tokens and equal counters (preemptions, retries, timeouts,
faults_injected, prefix evictions, ticks), with the pool balanced to the
page at the end."""

import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ExecOptions, build_model as jbuild
from repro.serve import faults as jfaults
from repro.serve import health as jhealth
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import (
    EngineOverloaded, EngineStats, ServeEngine)
from repro_torch.serve.faults import FaultEvent, FaultPlan, chaos_plan
from repro_torch.serve.health import Health, HealthConfig, ShardHealthMonitor

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

COUNTERS = ("preemptions", "retries", "timeouts", "rejected",
            "faults_injected", "prefix_evictions", "prefix_hits",
            "prefills", "prefill_chunks", "decode_steps", "tokens_out",
            "peak_pages_in_use", "pages_in_use")


@pytest.fixture(scope="module")
def smol():
    cfg = get_config("smollm-360m").smoke()
    jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=32))
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, build_model(cfg, device="cpu"), tp


def _prompt(seed, n=12, vocab=512):
    return np.asarray(
        jax.random.randint(jax.random.key(seed), (n,), 0, vocab), np.int32)


def _jax_plan(plan):
    """The port's FaultPlan as the JAX package's (the engines take their
    own package's plan)."""
    if plan is None:
        return None
    return jfaults.FaultPlan(events=tuple(
        jfaults.FaultEvent(**vars(e)) for e in plan.events), seed=plan.seed)


def _twins(smol, plan=None, **kw):
    """(JAX engine, port engine) on the same weights and options."""
    jm, jp, tm, tp = smol
    je = JaxEngine(jm, params=jp, fault_plan=_jax_plan(plan), **kw)
    te = ServeEngine(tm, params=tp, device="cpu", fault_plan=plan, **kw)
    return je, te


def _same_run(je, te, jr, tr):
    """Equal tokens, done and timed-out flags, counters and ticks."""
    for a, b in zip(jr, tr):
        assert (b.out_tokens, b.done, b.timed_out, b.preemptions) == \
            (a.out_tokens, a.done, a.timed_out, a.preemptions), a.rid
    for name in COUNTERS:
        assert getattr(te.stats, name) == getattr(je.stats, name), name
    assert te._tick == je._tick
    if te.paged:
        te.assert_accounting()
        assert te.pages_allocatable() == te.n_pages - 1
        assert not te._stolen_pages


# ------------------------------------------------------------------ FaultPlan
def _fields(plan):
    return [tuple(vars(e).values()) for e in plan.events]


def test_chaos_plan_replays_bit_for_bit():
    """The same seed gives the same plan, and the JAX package's plan."""
    kw = dict(n_shards=4, n_ticks=48, deaths=2, squeezes=4, sensor_storms=2)
    a, b = chaos_plan(7, **kw), chaos_plan(7, **kw)
    assert a == b and a.events == b.events
    assert a != chaos_plan(8, **kw)
    for seed in (7, 8, 123):
        assert _fields(chaos_plan(seed, **kw)) == \
            _fields(jfaults.chaos_plan(seed, **kw))
    ticks = [e.tick for e in a.events]
    assert ticks == sorted(ticks)
    assert sum(len(a.events_at(t)) for t in set(ticks)) == len(a.events)
    c = a.counts()
    assert c == jfaults.chaos_plan(7, **kw).counts()
    assert c["shard_death"] == c["shard_rejoin"] >= 1
    assert c["page_squeeze"] == c["page_restore"] >= 1
    assert c["sensor_hot"] == 2
    assert a.max_tick <= 48 + max(8, 6)


def test_fault_plan_validation():
    with pytest.raises(ValueError):
        FaultEvent(tick=1, kind="meteor_strike")
    with pytest.raises(ValueError):
        chaos_plan(0, n_shards=1, n_ticks=16, deaths=1)
    p = FaultPlan(events=(FaultEvent(tick=9, kind="page_restore"),
                          FaultEvent(tick=2, kind="page_squeeze", pages=4)))
    assert [e.tick for e in p.events] == [2, 9]
    assert p.max_tick == 9 and p.events_at(2)[0].pages == 4


# ------------------------------------------------------------- health machine
def _walk(mon, occupancy, ticks):
    out = []
    for _ in range(ticks):
        for s, old, new in mon.step(occupancy):
            out.append((mon._tick, s, old.value, new.value))
    return out


def test_health_machine_sensor_walks_drain_then_rejoin():
    """A hot sensor bias walks shard 0 HEALTHY → DEGRADED → DRAINING, then
    back through REJOINING to HEALTHY once it expires; shard 1 stays
    HEALTHY. The transitions, ticks and sensor readings are the JAX
    monitor's, and the trace replays."""
    occ = np.array([1.0, 0.2])

    def trace():
        mon = ShardHealthMonitor(2, HealthConfig(), device="cpu")
        mon.inject_sensor(0, delta_c=60.0, ticks=6)
        return _walk(mon, occ, 14), mon

    out, mon = trace()
    jmon = jhealth.ShardHealthMonitor(2, jhealth.HealthConfig())
    jmon.inject_sensor(0, delta_c=60.0, ticks=6)
    assert out == _walk(jmon, occ, 14)
    assert mon.state == [Health.HEALTHY, Health.HEALTHY]
    assert [(o, n) for _, _, o, n in out] == [
        ("healthy", "degraded"), ("degraded", "draining"),
        ("draining", "rejoining"), ("rejoining", "healthy")]
    assert all(s == 0 for _, s, _, _ in out)
    np.testing.assert_allclose(mon.sensor_c, jmon.sensor_c, rtol=1e-6)
    np.testing.assert_allclose(mon.clock_scale, jmon.clock_scale, rtol=1e-6)
    assert trace()[0] == out


def test_health_machine_force_dead_and_rejoin():
    mons = (ShardHealthMonitor(3, HealthConfig(rejoin_ticks=2), device="cpu"),
            jhealth.ShardHealthMonitor(3, jhealth.HealthConfig(
                rejoin_ticks=2)))
    for mon in mons:
        assert mon.force_dead(1) and not mon.force_dead(1)
        assert mon.placeable() == [True, False, True]
        assert not mon.begin_rejoin(0)
        assert mon.begin_rejoin(1)
    walks = [_walk(mon, np.zeros(3), 3) for mon in mons]
    assert walks[0] == walks[1] == [(2, 1, "rejoining", "healthy")]
    assert mons[0].state[1] == Health.HEALTHY
    assert mons[0].n_placeable() == 3
    assert mons[0].summary()["state"] == mons[1].summary()["state"]


# ------------------------------------------------------- validation + summary
def test_submit_validation_rejects_cleanly(smol):
    _, _, tm, tp = smol
    eng = ServeEngine(tm, n_slots=2, max_len=32, params=tp, page_size=8,
                      device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(np.zeros((2, 4), np.int32))
    with pytest.raises(ValueError, match="at least one token"):
        eng.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        eng.submit(_prompt(0, n=33))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(_prompt(0), max_new_tokens=0)
    assert not eng._queue and eng.stats.pages_in_use == 0
    r = eng.submit(_prompt(0), sample_params=(float("nan"), 5, float("nan")))
    assert r.temperature == 0.0 and r.top_p == 1.0


def test_queue_cap_overload(smol):
    """A full queue raises EngineOverloaded and counts the refusal; the
    accepted requests complete with the JAX engine's tokens."""
    je, te = _twins(smol, n_slots=1, max_len=64, page_size=8, max_queue=2)
    reqs = []
    for eng in (je, te):
        reqs.append([eng.submit(_prompt(i), max_new_tokens=2)
                     for i in range(2)])
    with pytest.raises(EngineOverloaded, match="cap"):
        te.submit(_prompt(9), max_new_tokens=2)
    with pytest.raises(RuntimeError):
        je.submit(_prompt(9), max_new_tokens=2)
    assert te.stats.rejected == je.stats.rejected == 1
    je.run_to_completion()
    te.run_to_completion()
    _same_run(je, te, *reqs)


def test_zero_run_summary_is_finite():
    """A run that never decoded summarizes to zeros, as the JAX engine's."""
    from repro.serve.engine import EngineStats as JaxStats
    s, j = EngineStats().summary(), JaxStats().summary()
    assert s["mean_occupancy"] == 0.0 and s["pad_waste_ratio"] == 0.0
    assert all(math.isfinite(v) for v in s.values()
               if isinstance(v, (int, float)))
    for name in COUNTERS:
        assert s[name] == j[name] == 0, name


# ------------------------------------------------------------- TTL + faults
def test_ttl_retires_stale_requests(smol):
    """Two queued requests with a 2-tick TTL retire before admission; an
    engine-wide TTL retires a live slot mid-decode, which releases its
    pages. Tokens and counters equal the JAX engine's."""
    for kw, ttls in ((dict(), (None, 2, 2)), (dict(ttl_ticks=4), (9, 1, 1))):
        je, te = _twins(smol, n_slots=1, max_len=64, page_size=8, **kw)
        reqs = []
        for eng in (je, te):
            reqs.append([eng.submit(_prompt(i), max_new_tokens=6,
                                    ttl_ticks=t) for i, t in enumerate(ttls)])
            eng.run_to_completion()
        _same_run(je, te, *reqs)
        keep, *stale = reqs[1]
        assert all(r.done and r.timed_out and not r.out_tokens for r in stale)
        assert te.stats.timeouts == 2
        assert keep.done and not keep.timed_out and len(keep.out_tokens) == 6
    # the engine TTL of 4 retires the third request live, mid-decode
    je, te = _twins(smol, n_slots=2, max_len=64, page_size=8, ttl_ticks=4)
    reqs = []
    for eng in (je, te):
        reqs.append([eng.submit(_prompt(i, 20), max_new_tokens=m)
                     for i, m in enumerate((2, 12))])
        eng.run_to_completion()
    _same_run(je, te, *reqs)
    assert reqs[1][1].timed_out and reqs[1][1].out_tokens
    assert te.stats.timeouts == 1


def test_single_host_squeeze_parity_and_zero_leak(smol):
    """A page squeeze starves admission mid-run; after the restore every
    request completes with the tokens of a fault-free twin and of the JAX
    engine under the same plan, and the pool balances to the page."""
    lens, new = [9, 17, 6, 23, 13, 11], [6, 4, 8, 3, 5, 6]
    plan = FaultPlan(events=(
        FaultEvent(tick=3, kind="page_squeeze", pages=6),
        FaultEvent(tick=12, kind="page_restore")))
    runs = {}
    for name, p in (("base", None), ("chaos", plan)):
        je, te = _twins(smol, p, n_slots=2, max_len=64, page_size=8,
                        n_pages=9)
        reqs = []
        for eng in (je, te):
            reqs.append([eng.submit(_prompt(i, n), max_new_tokens=m,
                                    seed=100 + i)
                         for i, (n, m) in enumerate(zip(lens, new))])
            eng.run_to_completion()
        _same_run(je, te, *reqs)
        runs[name] = (te, reqs[1])
    eng, chaos = runs["chaos"]
    assert eng.stats.faults_injected == 2
    assert eng._tick > runs["base"][0]._tick        # the squeeze held work
    for a, b in zip(runs["base"][1], chaos):
        assert a.done and b.done and not b.timed_out
        assert a.out_tokens == b.out_tokens
    assert eng.stats.pages_in_use == 0


def test_pool_exhaustion_queues_fifo_single_host(smol):
    """More work than the pool holds at once: admission queues (each
    request reserves 2 of 3 usable pages, so one is live at a time) and
    drains strictly FIFO, tick for tick with the JAX engine."""
    je, te = _twins(smol, n_slots=4, max_len=64, page_size=8, n_pages=4)
    reqs = [[eng.submit(_prompt(i), max_new_tokens=4, seed=100 + i)
             for i in range(4)] for eng in (je, te)]
    finished = []
    for _ in range(400):
        live = te.step()
        je.step()
        for r in reqs[1]:
            if r.done and r.rid not in finished:
                finished.append(r.rid)
        if not live:
            break
    assert all(r.done and not r.timed_out and len(r.out_tokens) == 4
               for r in reqs[1])
    assert finished == sorted(finished)
    _same_run(je, te, *reqs)


def test_preemption_resumes_token_exact(smol):
    """A request put back in the queue (as the sharded engine's recovery
    requeues one) heads it, older than the slots decoding: the one way a
    single-host engine reaches preemption. With the pool squeezed it starves
    for PREEMPT_AFTER ticks and preempts the youngest decoding slot,
    which re-prefills its prompt and emitted tokens and resumes. Every
    stream equals the undisturbed run's, and tokens, preemptions, retries
    and ticks equal the JAX engine's through the same steps."""
    lens = [10, 14, 18]

    def leg(disturb):
        plan = FaultPlan(events=(
            FaultEvent(tick=4, kind="page_squeeze", pages=16),
            FaultEvent(tick=14, kind="page_restore"))) if disturb else None
        je, te = _twins(smol, plan, n_slots=3, max_len=64, page_size=8,
                        n_pages=12, chunk_pages=1)
        reqs = [[eng.submit(_prompt(20 + i, n), max_new_tokens=10)
                 for i, n in enumerate(lens)] for eng in (je, te)]
        for _ in range(3):
            je.step()
            te.step()
        if disturb:
            for eng, rs in zip((je, te), reqs):
                slot = eng._slots.index(rs[0])
                eng._release(slot)
                eng._requeue(rs[0])
        je.run_to_completion()
        te.run_to_completion()
        _same_run(je, te, *reqs)
        return te, reqs[1]

    base, base_reqs = leg(False)
    eng, reqs = leg(True)
    assert eng.stats.preemptions >= 1 and eng.stats.retries >= 1
    assert sum(r.preemptions for r in reqs) == eng.stats.preemptions
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in base_reqs]


def test_squeeze_steals_cached_pages_with_parity(smol):
    """A page squeeze dips into the prefix cache's LRU once the free list
    is dry: cached pages are sacrificed (counted as evictions), tokens stay
    equal to a fault-free twin and to the JAX engine, and the restore
    returns every stolen page."""
    _, _, tm, tp = smol
    sysp = _prompt(17, 32)
    kw = dict(n_slots=2, max_len=64, n_pages=11, page_size=8, chunk_pages=1,
              prefix_cache=True)

    def wave(eng):
        warm = eng.submit(sysp, max_new_tokens=4)
        eng.run_to_completion()
        rs = [eng.submit(np.concatenate([sysp, _prompt(100 + i, 4 + 3 * i)]),
                         max_new_tokens=4, seed=50 + i) for i in range(3)]
        eng.run_to_completion()
        return [warm] + rs

    probe = ServeEngine(tm, params=tp, device="cpu", **kw)
    probe.submit(sysp, max_new_tokens=4)
    probe.run_to_completion()
    t = probe._tick + 1
    assert probe.stats.prefix_cached_pages == 4
    plan = FaultPlan(events=(
        FaultEvent(tick=t, kind="page_squeeze", pages=8),
        FaultEvent(tick=t + 6, kind="page_restore")))
    toks = {}
    for name, p in (("base", None), ("chaos", plan)):
        je, te = _twins(smol, p, **kw)
        jr, tr = wave(je), wave(te)
        _same_run(je, te, jr, tr)
        toks[name] = [r.out_tokens for r in tr]
    assert te.stats.faults_injected == 2
    assert te.stats.prefix_evictions == 2       # the LRU gave 8 - 6
    assert toks["base"] == toks["chaos"]
