"""Port parity, the sharded engine under faults: the port's
`ShardedServeEngine` against the JAX package's on the fault cases of
`tests/test_migration.py` (a sensor-driven drain by migration and by
replay, chaos with migration on 8 shards, elastic rebalancing after a
rejoin, cross-shard prefix replication) and the sharded cases of
`tests/test_chaos.py` (the seeded chaos matrix of shard deaths, rejoins
and page squeezes on a tight pool, the same on the moe family with int8
weights and KV, a sensor-driven drain).

As in `tests/test_torch_migration.py`, whose harness this file uses, the
reference runs the scenarios once a module in a subprocess on a forced
8-device CPU mesh and the port runs the same scenario code in process on
the bridged weights: tokens, the migration, recovery, preemption and
prefill counters and `shard_summary()` must be equal. The reference
tests' own gates hold on the port too: every stream equals its fault-free
twin, a drain by migration prefills no more chunks than the fault-free
run while replay prefills more, a replayed plan repeats its counters,
and pool accounting is exact."""

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


# ---------------------------------------------------------------- scenarios
def drain(api):
    """A sensor-hot shard 1 drains by migration (and, with migration off,
    by replay), beside the fault-free run."""
    plan = api.plan((4, "sensor_hot", 1, dict(delta_c=60.0, ticks=8)))
    lens = [5 + (i * 7) % 23 for i in range(5)]
    out = {}
    for name, p, mig in (("free", None, True), ("mig", plan, True),
                         ("rep", plan, False)):
        eng = api.engine("smollm-360m", 4, n_slots=8, max_len=64,
                         page_size=8, n_pages=24, fault_plan=p,
                         migration=mig)
        reqs = [eng.submit(prompt(i, n), max_new_tokens=12, seed=100 + i)
                for i, n in enumerate(lens)]
        eng.run_to_completion()
        eng.assert_pool_accounting()
        eng.assert_local_page_tables()
        out[name] = summary(eng, reqs)
    return {"tokens": out["mig"]["tokens"], "counters": out["mig"]["counters"],
            "shard_summary": out["mig"]["shard_summary"],
            "free": out["free"], "rep": out["rep"]}


def chaos_migration(api):
    """Deaths, squeezes and sensor storms on 8 shards, migration on."""
    F = api.faults
    plan = F.chaos_plan(3, n_shards=8, n_ticks=48, deaths=1, death_dwell=12,
                        squeezes=2, squeeze_pages=6, squeeze_dwell=8,
                        sensor_storms=2, sensor_delta_c=60.0, sensor_ticks=8)
    lens = [5 + (i * 7) % 23 for i in range(6)]
    eng = api.engine("smollm-360m", 8, n_slots=8, max_len=64, page_size=8,
                     n_pages=16, fault_plan=plan)
    reqs = [eng.submit(prompt(i, n), max_new_tokens=12, seed=100 + i)
            for i, n in enumerate(lens)]
    eng.run_to_completion()
    eng.assert_pool_accounting()
    eng.assert_local_page_tables()
    return summary(eng, reqs, health=eng.health_summary()["state"])


def rebalance(api):
    """A drain empties shard 0; after it rejoins, threshold 1 pulls live
    slots back onto it (threshold 0: no rebalancing)."""
    plan = api.plan((4, "sensor_hot", 0, dict(delta_c=60.0, ticks=8)))
    lens = [9, 12, 15, 18, 11, 14]
    out = {}
    for thr in (0, 1):
        eng = api.engine("smollm-360m", 4, n_slots=8, max_len=96,
                         page_size=8, n_pages=36, fault_plan=plan,
                         rebalance_threshold=thr)
        reqs = [eng.submit(prompt(i, n), max_new_tokens=24, seed=100 + i)
                for i, n in enumerate(lens)]
        eng.run_to_completion()
        eng.assert_pool_accounting()
        eng.assert_local_page_tables()
        out[thr] = summary(eng, reqs)
    res = dict(out[1])
    res["thr0"] = out[0]
    return res


def replication(api):
    """A hot prefix whose home shard is full replicates to another shard
    (and, with migration off, re-prefills there)."""
    sysp = prompt(0, 16)
    out = {}
    for mig in (True, False):
        eng = api.engine("smollm-360m", 4, n_slots=8, max_len=96,
                         page_size=8, migration=mig)
        r0 = eng.submit(sysp.copy(), max_new_tokens=2)
        eng.run_to_completion()
        rs = [eng.submit(np.concatenate([sysp, prompt(9 + i, 5 + i)]),
                         max_new_tokens=40, seed=50 + i) for i in range(2)]
        for _ in range(6):
            eng.step()
        r3 = eng.submit(np.concatenate([sysp, prompt(20, 6)]),
                        max_new_tokens=6, seed=70)
        eng.run_to_completion()
        eng.assert_pool_accounting()
        eng.assert_local_page_tables()
        out[mig] = summary(eng, [r0] + rs + [r3],
                           r3_cached=r3.cached_prompt_tokens)
    res = dict(out[True])
    res["off"] = out[False]
    return res


def _chaos_run(api, plan, arch="smollm-360m", n_req=16, max_new=16,
               n_pages=13, **kw):
    """The reference's `chaos_parity` traffic on 4 shards under `plan`."""
    lens = [5 + (i * 7) % 23 for i in range(n_req)]
    eng = api.engine(arch, 4, n_slots=8, max_len=64, page_size=8,
                     n_pages=n_pages, fault_plan=plan, **kw)
    reqs = [eng.submit(prompt(i, n), max_new_tokens=max_new, seed=100 + i)
            for i, n in enumerate(lens)]
    eng.run_to_completion()
    eng.assert_pool_accounting()
    eng.assert_local_page_tables()
    assert all(r.done and not r.timed_out for r in reqs)
    health = eng.health_summary()
    return summary(eng, reqs,
                   health=None if health is None else health["state"])


def _seed_plan(api, seed):
    return api.faults.chaos_plan(
        seed, n_shards=4, n_ticks=56, deaths=2, death_dwell=16, squeezes=8,
        squeeze_pages=10, squeeze_dwell=14)


def _chaos_seed(seed):
    def run(api):
        return _chaos_run(api, _seed_plan(api, seed))
    return run


MOE_INT8 = dict(arch="qwen2-moe-a2.7b", n_req=8, max_new=8,
                wdtype="int8", kv_dtype="int8")


def _moe_plan(api):
    return api.faults.chaos_plan(2, n_shards=4, n_ticks=40, deaths=1,
                                 death_dwell=12, squeezes=4,
                                 squeeze_pages=10, squeeze_dwell=10)


def chaos_moe_int8(api):
    return _chaos_run(api, _moe_plan(api), **MOE_INT8)


def _sensor_plan(api):
    return api.plan((4, "sensor_hot", 1, dict(delta_c=60.0, ticks=8)))


def sensor_drain(api):
    return _chaos_run(api, _sensor_plan(api), n_req=12, max_new=12,
                      n_pages=16)


SCENARIOS = dict(drain=drain, chaos_migration=chaos_migration,
                 rebalance=rebalance, replication=replication,
                 chaos_seed2=_chaos_seed(2), chaos_seed3=_chaos_seed(3),
                 chaos_moe_int8=chaos_moe_int8, sensor_drain=sensor_drain)


# -------------------------------------------------------------------- tests
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


def test_drain_by_migration_costs_no_prefill(port):
    """Migration, replay and the fault-free run give one stream each; the
    migration run prefills exactly the fault-free chunks, replay more."""
    d = port["drain"]
    assert d["tokens"] == d["free"]["tokens"] == d["rep"]["tokens"]
    st = d["counters"]
    assert st["migrations"] >= 1 and st["migrated_pages"] >= 1
    assert st["migrated_bytes_compressed"] > 0
    assert st["recoveries"] >= 1
    assert st["recovery_ticks_sum"] >= st["recoveries"]
    assert st["prefill_chunks"] == d["free"]["counters"]["prefill_chunks"]
    assert d["rep"]["counters"]["prefill_chunks"] \
        > d["free"]["counters"]["prefill_chunks"]
    assert d["rep"]["counters"]["migrations"] == 0


def test_chaos_with_migration_keeps_every_stream(port):
    res = port["chaos_migration"]
    eng = Api("torch").engine("smollm-360m", 8, n_slots=8, max_len=64,
                              page_size=8, n_pages=16)
    lens = [5 + (i * 7) % 23 for i in range(6)]
    reqs = [eng.submit(prompt(i, n), max_new_tokens=12, seed=100 + i)
            for i, n in enumerate(lens)]
    eng.run_to_completion()
    assert res["tokens"] == [list(r.out_tokens) for r in reqs]
    st = res["counters"]
    assert st["faults_injected"] >= 3 and st["migrations"] >= 1
    assert st["recoveries"] >= 1


def test_rebalance_moves_load_back(port):
    res = port["rebalance"]
    assert res["tokens"] == res["thr0"]["tokens"]
    assert res["thr0"]["counters"]["rebalance_events"] == 0
    assert res["counters"]["rebalance_events"] >= 1
    imb0 = res["thr0"]["shard_summary"]["occupancy_imbalance"]
    imb1 = res["shard_summary"]["occupancy_imbalance"]
    assert imb1 < imb0 and imb1 < 0.67


def test_prefix_replication_saves_prefill(port):
    res = port["replication"]
    assert res["counters"]["migrated_pages"] >= 2
    assert res["r3_cached"] >= 16
    assert res["off"]["counters"]["migrated_pages"] == 0
    assert res["tokens"] == res["off"]["tokens"]
    assert res["counters"]["prefill_chunks"] \
        < res["off"]["counters"]["prefill_chunks"]


@pytest.mark.parametrize("seed", [2, 3])
def test_chaos_matrix_keeps_every_stream(seed, port):
    """Deaths, rejoins and squeezes: zero divergence from the fault-free
    twin, deaths displace work, and the same plan replays its counters."""
    res = port[f"chaos_seed{seed}"]
    api = Api("torch")
    free = _chaos_run(api, None)
    assert res["tokens"] == free["tokens"]
    st = res["counters"]
    assert st["faults_injected"] >= 4 and st["recoveries"] >= 1
    assert st["recovery_ticks_sum"] >= st["recoveries"]
    assert _chaos_run(api, _seed_plan(api, seed))["counters"] == st


def test_chaos_matrix_preempts(port):
    """Over the two seeds the tight pool preempts decoding slots."""
    assert sum(port[f"chaos_seed{s}"]["counters"]["preemptions"]
               for s in (2, 3)) >= 3
    assert sum(port[f"chaos_seed{s}"]["counters"]["recoveries"]
               for s in (2, 3)) >= 2


def test_chaos_moe_int8_keeps_every_stream(port):
    res = port["chaos_moe_int8"]
    free = _chaos_run(Api("torch"), None, **MOE_INT8)
    assert res["tokens"] == free["tokens"]
    assert res["counters"]["faults_injected"] >= 2


def test_sensor_drain_rejoins_healthy(port):
    res = port["sensor_drain"]
    free = _chaos_run(Api("torch"), None, n_req=12, max_new=12, n_pages=16)
    assert res["tokens"] == free["tokens"]
    assert res["counters"]["faults_injected"] == 1
    assert res["counters"]["recoveries"] >= 1
    assert res["health"] == ["healthy"] * 4
