"""Port parity, the SoC model's modules: `repro_torch.core` against
`repro.core` on the CPU, module by module, with inputs made by numpy from a
seed. The reference runs eagerly here (each op rounded on its own), the port
as the compiled reference tick rounds (`repro_torch.rounding`), so floats are
held at rtol 1e-5 / atol 1e-6 (1e-6 where the two round alike); P-state
levels, migrations, throttle counts, Merkle bytes, plan decisions and the
uniform draws are held exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dvfs as jdvfs
from repro.core import planner as jplanner
from repro.core import scenarios as jscen
from repro.core import security as jsec
from repro.core import thermal as jthermal
from repro.core import ucie as jucie
from repro.core import workloads as jwork

from repro_torch import prng
from repro_torch.core import dvfs as tdvfs
from repro_torch.core import planner as tplanner
from repro_torch.core import scenarios as tscen
from repro_torch.core import security as tsec
from repro_torch.core import thermal as tthermal
from repro_torch.core import ucie as tucie
from repro_torch.core import workloads as twork

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


# ----------------------------------------------------------------- vectors
@pytest.mark.parametrize("name", jscen.SCENARIO_ORDER)
def test_scenario_vectors_equal(name):
    want = np.asarray(jscen.SCENARIOS[name].as_vector())
    got = tscen.SCENARIOS[name].as_vector("cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert tscen.Scenario.vector_fields() == jscen.Scenario.vector_fields()
    assert tscen.SCENARIOS[name].is_monolithic \
        == jscen.SCENARIOS[name].is_monolithic


@pytest.mark.parametrize("name", jwork.WORKLOAD_ORDER)
def test_workload_vectors_equal(name):
    want = np.asarray(jwork.WORKLOADS[name].as_vector())
    got = twork.get_workload(name).as_vector("cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(twork.WORKLOADS[name]) \
        == dataclasses.asdict(jwork.WORKLOADS[name])


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscen.AI_OPTIMIZED.as_vector()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdvfs.init_state(6, tdvfs.DVFSConfig())


# ------------------------------------------------------------------- ucie
def _ucie_cfgs():
    return [dict(), dict(streaming=False, compression_ratio=1.0),
            dict(bandwidth_gbps=8.0, latency_us=8.0, compression_ratio=0.6)]


@pytest.mark.parametrize("i_cfg", range(3))
def test_transfer_matches(i_cfg):
    kw = _ucie_cfgs()[i_cfg]
    rng = np.random.default_rng(i_cfg)
    payload = np.concatenate([[0.0, 1.0, 64.0, 65.0],
                              rng.uniform(0, 2e6, 60)]).astype(np.float32)
    want = jucie.transfer(jnp.asarray(payload), jucie.UCIeConfig(**kw))
    got = tucie.transfer(_t(payload), tucie.UCIeConfig(**kw))
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    # the vector encoding takes the same path
    vec = tucie.UCIeConfig(**kw).as_vector("cpu")
    np.testing.assert_array_equal(vec.numpy(),
                                  np.asarray(jucie.UCIeConfig(**kw).as_vector()))


@pytest.mark.parametrize("i_cfg", range(3))
def test_migration_ticks_equal(i_cfg):
    kw = _ucie_cfgs()[i_cfg]
    rng = np.random.default_rng(10 + i_cfg)
    for payload in [0.0, 4096.0, *rng.uniform(0, 4e6, 20)]:
        for tick_us in (1.0, 50.0, 1000.0):
            want = jucie.migration_ticks(float(payload),
                                         jucie.UCIeConfig(**kw),
                                         tick_us=tick_us)
            got = tucie.migration_ticks(float(payload),
                                        tucie.UCIeConfig(**kw),
                                        tick_us=tick_us, device="cpu")
            assert got == want, (payload, tick_us)


def test_link_tick_matches():
    rng = np.random.default_rng(3)
    js, ts = jucie.init_link(), tucie.init_link(device="cpu")
    jcfg, tcfg = jucie.UCIeConfig(), tucie.UCIeConfig()
    for payload in [0.0, *rng.uniform(0, 3e5, 30).astype(np.float32)]:
        js, jout = jucie.link_tick(js, jnp.float32(payload), jcfg, 0.1)
        ts, tout = tucie.link_tick(ts, torch.tensor(payload,
                                                    dtype=torch.float32),
                                   tcfg, 0.1)
        for g, w in zip(tout, jout):
            _close(g.numpy(), np.asarray(w))
        _close(ts.queued_bytes.numpy(), np.asarray(js.queued_bytes))
        _close(ts.energy_mj.numpy(), np.asarray(js.energy_mj))


# --------------------------------------------------------------- security
@pytest.mark.parametrize("n", [1, 2, 5, 6, 17])
@pytest.mark.parametrize("enabled", [True, False])
def test_security_costs_equal(n, enabled):
    jcfg = jsec.SecurityConfig(enabled=enabled)
    tcfg = tsec.SecurityConfig(enabled=enabled)
    assert float(tsec.attestation_latency_us(n, tcfg, "cpu")) \
        == float(jsec.attestation_latency_us(n, jcfg))
    assert float(tsec.centralized_attestation_latency_us(n, tcfg, "cpu")) \
        == float(jsec.centralized_attestation_latency_us(n, jcfg))
    p = np.random.default_rng(n).uniform(0, 1e6, 16).astype(np.float32)
    for g, w in zip(tsec.aead_overhead(_t(p), tcfg),
                    jsec.aead_overhead(jnp.asarray(p), jcfg)):
        _close(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_leaves", [0, 1, 2, 5, 8])
def test_merkle_bytes_equal(n_leaves):
    rng = np.random.default_rng(n_leaves)
    payloads = {f"shard{i}": rng.bytes(int(rng.integers(0, 200)))
                for i in range(n_leaves)}
    key = b"session-key"
    leaves = [tsec.leaf_digest(k, v) for k, v in sorted(payloads.items())]
    assert leaves == [jsec.leaf_digest(k, v)
                      for k, v in sorted(payloads.items())]
    root = tsec.merkle_root(leaves)
    assert root == jsec.merkle_root(leaves)
    for i in range(n_leaves):
        proof = tsec.merkle_proof(leaves, i)
        assert proof == jsec.merkle_proof(leaves, i)
        assert tsec.verify_proof(leaves[i], proof, root)
    assert tsec.seal(root, key) == jsec.seal(root, key)
    manifest = tsec.attest_manifest(payloads, key)
    assert manifest == jsec.attest_manifest(payloads, key)
    assert tsec.verify_manifest(payloads, key, manifest)
    if payloads:
        tampered = dict(payloads, shard0=payloads["shard0"] + b"x")
        assert not tsec.verify_manifest(tampered, key, manifest)


# ------------------------------------------------------------------- dvfs
def _dvfs_case(seed, batch=64, n=6):
    rng = np.random.default_rng(seed)
    level = rng.integers(0, 8, (batch, n)).astype(np.int32)
    ema = rng.uniform(0, 1.3, (batch, n)).astype(np.float32)
    energy = rng.uniform(0, 10, batch).astype(np.float32)
    demand = rng.uniform(0, 1.25, (batch, n)).astype(np.float32)
    demand[: batch // 4] *= 0.3          # idle rows, so boosts happen
    peak = rng.uniform(20, 400, (batch, n)).astype(np.float32)
    static = rng.uniform(5, 60, (batch, n)).astype(np.float32)
    budget = rng.uniform(300, 1500, batch).astype(np.float32)
    adaptive = rng.integers(0, 2, batch).astype(bool)
    return level, ema, energy, demand, peak, static, budget, adaptive


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dvfs_step_matches(seed):
    level, ema, energy, demand, peak, static, budget, adaptive = \
        _dvfs_case(seed)

    def ref_one(lv, em, en, d, pk, st, bu, ad):
        cfg = jdvfs.DVFSConfig(power_budget_mw=bu, adaptive=ad)
        s, out = jdvfs.step(jdvfs.DVFSState(lv, em, en), d, cfg, pk, st, 0.1)
        return (s.level, s.load_ema, s.energy_mj) + out

    want = jax.vmap(ref_one)(*map(jnp.asarray, (level, ema, energy, demand,
                                                 peak, static, budget,
                                                 adaptive)))
    cfg = tdvfs.DVFSConfig(power_budget_mw=_t(budget), adaptive=_t(adaptive))
    s, out = tdvfs.step(tdvfs.DVFSState(_t(level), _t(ema), _t(energy)),
                        _t(demand), cfg, _t(peak), _t(static), 0.1)
    got = (s.level, s.load_ema, s.energy_mj) + out
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32
    for g, w in zip(got[1:], want[1:]):
        _close(g.numpy(), np.asarray(w))
    # the redistribution paths all ran: over budget, boosted, held
    assert (got[0].numpy() > level).any() and (got[0].numpy() < level).any()


def test_dvfs_init_and_power_model():
    cfg = tdvfs.DVFSConfig()
    s = tdvfs.init_state(6, cfg, device="cpu")
    js = jdvfs.init_state(6, jdvfs.DVFSConfig())
    np.testing.assert_array_equal(s.level.numpy(), np.asarray(js.level))
    assert cfg.n_levels == jdvfs.DVFSConfig().n_levels
    for g, w in zip(tdvfs.uniform_power_model(4, device="cpu"),
                    jdvfs.uniform_power_model(4)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------- thermal
def _thermal_case(seed, batch=64):
    rng = np.random.default_rng(seed)
    temp = rng.uniform(44.9, 45.2, (batch, 6)).astype(np.float32)
    temp[: batch // 8, 1:3] = temp[: batch // 8, 1:2]   # tied NPUs
    migr = rng.integers(0, 50, batch).astype(np.int32)
    thr = rng.integers(0, 50, batch).astype(np.int32)
    power = rng.uniform(0, 600, (batch, 6)).astype(np.float32)
    load = rng.uniform(0, 3, (batch, 6)).astype(np.float32)
    load[batch // 8: batch // 4, 1] = 0.0                # unloaded donor
    r = rng.uniform(5, 20, 6).astype(np.float32)
    c = rng.uniform(0.3, 3, 6).astype(np.float32)
    return temp, migr, thr, power, load, r, c


def _thermal_cfgs(r, c):
    kw = dict(t_migrate_c=45.01, t_throttle_c=45.02, t_critical_c=45.1)
    return (jthermal.ThermalConfig(tuple(r.tolist()), tuple(c.tolist()), **kw),
            tthermal.ThermalConfig(tuple(r.tolist()), tuple(c.tolist()), **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("predictive", [True, False])
def test_thermal_step_matches(seed, predictive):
    temp, migr, thr, power, load, r, c = _thermal_case(seed)
    jcfg, tcfg = _thermal_cfgs(r, c)
    jcfg = dataclasses.replace(jcfg, predictive=predictive)
    tcfg = dataclasses.replace(tcfg, predictive=predictive)
    mask = np.array([False, True, True, False, False, False])

    def ref_one(t, m, th, p, ld):
        s, out = jthermal.step(jthermal.ThermalState(t, m, th), p,
                               jnp.asarray(mask), ld, jcfg, 0.1)
        return (s.temp_c, s.migrations, s.throttle_ticks) + out

    want = jax.vmap(ref_one)(*map(jnp.asarray, (temp, migr, thr, power,
                                                 load)))
    s, out = tthermal.step(tthermal.ThermalState(_t(temp), _t(migr), _t(thr)),
                           _t(power), _t(mask), _t(load), tcfg, 0.1)
    got = (s.temp_c, s.migrations, s.throttle_ticks) + out
    _close(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[3:], want[3:]):
        _close(g.numpy(), np.asarray(w))
    moved = got[1].numpy() - migr
    assert (moved == 1).any() == predictive and (moved >= 0).all()
    assert (got[2].numpy() > thr).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_thermal_predict_and_init_match(seed):
    temp, migr, thr, power, _, r, c = _thermal_case(seed)
    jcfg, tcfg = _thermal_cfgs(r, c)
    want = jax.vmap(lambda t, m, th, p: jthermal.predict(
        jthermal.ThermalState(t, m, th), p, jcfg, 0.1))(
            *map(jnp.asarray, (temp, migr, thr, power)))
    got = tthermal.predict(tthermal.ThermalState(_t(temp), _t(migr), _t(thr)),
                           _t(power), tcfg, 0.1)
    _close(got.numpy(), np.asarray(want))
    js, ts = jthermal.init_state(jcfg), tthermal.init_state(tcfg,
                                                            device="cpu")
    np.testing.assert_array_equal(ts.temp_c.numpy(), np.asarray(js.temp_c))


# ---------------------------------------------------------------- planner
@pytest.mark.parametrize("seed", range(4))
def test_plan_decisions_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        kw = dict(flops=float(10 ** rng.uniform(9, 16)),
                  hbm_bytes=float(10 ** rng.uniform(6, 13)),
                  collective_bytes=float(10 ** rng.uniform(3, 12)),
                  chips=int(rng.integers(1, 257)),
                  model_flops=float(10 ** rng.uniform(8, 16)))
        train = bool(rng.integers(0, 2))
        resident = None if rng.uniform() < 0.3 else float(
            rng.uniform(0, 1.2) * 16e9)
        want = jplanner.plan(jplanner.RooflineTerms(**kw), is_training=train,
                             resident_bytes_per_chip=resident)
        got = tplanner.plan(tplanner.RooflineTerms(**kw), is_training=train,
                            resident_bytes_per_chip=resident)
        assert got.as_dict() == want.as_dict()
        assert tplanner.RooflineTerms(**kw).summary() \
            == jplanner.RooflineTerms(**kw).summary()


# ------------------------------------------------------------------- prng
@pytest.mark.parametrize("seed,shape,lo,hi", [
    (0, (20000, 12), 0.7, 1.3),     # examples/design_space.py's candidates
    (0, (4096, 30), 0.8, 1.2),      # chip_smoke.py (j4)'s design factors
    (7, (3, 4, 5), -2.0, 3.0),
    (11, (9,), 0.0, 1.0),
])
def test_shaped_uniform_bit_equal(seed, shape, lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape,
                                         minval=lo, maxval=hi))
    got = prng.uniform(prng.key(seed), shape, lo, hi).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed,shape", [(0, (2, 32)), (1, (64, 100)),
                                        (5, (7,))])
def test_normal_matches(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = prng.normal(prng.key(seed), shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
