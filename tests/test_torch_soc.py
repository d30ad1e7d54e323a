"""Port parity, the SoC model as a whole: the closed-form model and the
time-stepped simulator of `repro_torch.core` against `repro.core` on the
CPU, the paper's claims and `BENCH_soc.json`'s deterministic fields
reproduced by the port, and the reference's `simulate_batch` properties.
The card's run is held to the CPU's in `tests/test_torch_soc_cuda.py`.

Tolerances: the closed-form model rtol 1e-6 (gradients 1e-4, noisy runs
1e-5); simulator floats rtol 1e-5; migrations, throttle ticks and the 5 ms
knees exactly. The simulator's tick rounds as the reference's compiled scan
does, so on these grids every state field is in fact bit-equal
(`tools/torch_soc_diff.py` shows it tick by tick); only the mean power is
summed in another order."""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import perf_model as jpm
from repro.core import soc as jsoc
from repro.core.scenarios import SCENARIOS as JSCEN
from repro.core.scenarios import SCENARIO_ORDER
from repro.core.workloads import WORKLOADS as JWORK
from repro.core.workloads import WORKLOAD_ORDER

from repro_torch import prng
from repro_torch.bridge import soc_params_from_numpy
from repro_torch.core import perf_model as tpm
from repro_torch.core import soc as tsoc
from repro_torch.core.scenarios import SCENARIOS as TSCEN
from repro_torch.core.workloads import WORKLOADS as TWORK

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JM, TM = JWORK["mobilenetv2"], TWORK["mobilenetv2"]
BATCHES = [1, 2, 4, 8, 16]
# BENCH_soc's rate grid, and examples/design_space.py's (the reference's
# own f32 linspace, fed to both)
PAPER_RATES = np.float32([25., 50., 100., 150., 200., 300., 500., 1000.])
HOT_RATES = np.array(jnp.linspace(25.0, 1500.0, 16))
COUNTERS = ("migrations", "throttle_ticks")


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


def _hold_metrics(got, want, rtol=1e-5):
    """Every metric of the simulator: counters and non-finite entries
    exactly, floats at rtol."""
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].cpu().numpy()
        assert g.shape == w.shape, k
        if k in COUNTERS:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w),
                                      err_msg=k)
        fin = np.isfinite(w)
        _close(g[fin], w[fin], rtol)


def _knees(latency, rates):
    """Per scenario, the largest rate still meeting the 5 ms deadline."""
    lat = np.asarray(latency)
    return [float(np.max(np.where(lat[i] <= 5.0, rates, 0.0)))
            for i in range(lat.shape[0])]


def _socs(build, scen, hot):
    socs = [build(scen[s]) for s in SCENARIO_ORDER]
    return [tsoc.hot_variant(s) for s in socs] if hot else socs


@pytest.fixture(scope="module")
def grids():
    """(reference, port) simulate_batch over the 4 scenarios, 200 ms: the
    paper's floorplan at BENCH_soc's 8 rates, the hot variant at 16."""
    out = {}
    for name, rates, hot in (("paper", PAPER_RATES, False),
                             ("hot", HOT_RATES, True)):
        want = jsoc.simulate_batch(_socs(jsoc.build_soc, JSCEN, hot), JM,
                                   jnp.asarray(rates), duration_ms=200.0)
        got = tsoc.simulate_batch(_socs(tsoc.build_soc, TSCEN, hot), TM,
                                  torch.from_numpy(rates), duration_ms=200.0,
                                  device="cpu")
        out[name] = (want, got, rates)
    return out


# --------------------------------------------------------- closed-form model
def test_predict_grid_matches():
    want = jpm.predict_grid([JSCEN[s] for s in SCENARIO_ORDER],
                            [JWORK[w] for w in WORKLOAD_ORDER], BATCHES)
    got = tpm.predict_grid([TSCEN[s] for s in SCENARIO_ORDER],
                           [TWORK[w] for w in WORKLOAD_ORDER], BATCHES,
                           device="cpu")
    for f in dataclasses.fields(jpm.PerfResult):
        w, g = np.asarray(getattr(want, f.name)), getattr(got, f.name).numpy()
        assert g.shape == w.shape == (4, 3, 5), f.name
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            _close(g, w, 1e-6)


@pytest.mark.parametrize("scenario", SCENARIO_ORDER)
@pytest.mark.parametrize("workload", WORKLOAD_ORDER)
def test_predict_matches(scenario, workload):
    for b in BATCHES:
        want = jpm.predict(JSCEN[scenario], JWORK[workload], b)
        got = tpm.predict(TSCEN[scenario], TWORK[workload], b, device="cpu")
        for f in dataclasses.fields(jpm.PerfResult):
            w, g = np.asarray(getattr(want, f.name)), \
                getattr(got, f.name).numpy()
            if w.dtype == bool:
                assert bool(g) == bool(w), (f.name, b)
            else:
                _close(g, w, 1e-6)


@pytest.mark.parametrize("scenario", SCENARIO_ORDER)
@pytest.mark.parametrize("metric", ["tops_per_w", "latency_ms"])
def test_gradients_match_jax_grad(scenario, metric):
    wv = JM.as_vector()
    want = np.asarray(jax.grad(lambda v: getattr(
        jpm.predict_vec(v, wv, jnp.float32(1.0)), metric))(
            JSCEN[scenario].as_vector()))
    v = TSCEN[scenario].as_vector("cpu").requires_grad_(True)
    getattr(tpm.predict_vec(v, TM.as_vector("cpu"), 1.0), metric).backward()
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("seed,batch", [(0, 1), (3, 4), (9, 16)])
def test_predict_noisy_matches(seed, batch):
    want = jpm.predict_noisy(jax.random.key(seed), JSCEN["ai_optimized"], JM,
                             batch)
    got = tpm.predict_noisy(prng.key(seed), TSCEN["ai_optimized"], TM, batch,
                            device="cpu")
    for f in ("latency_ms", "power_mw", "throughput_ips", "tops_per_w",
              "energy_mj"):
        _close(getattr(got, f).numpy(), np.asarray(getattr(want, f)), 1e-5)
    np.testing.assert_array_equal(got.realtime_ok.numpy(),
                                  np.asarray(want.realtime_ok))


# ------------------------------------------------------------- the simulator
@pytest.mark.parametrize("scenario", SCENARIO_ORDER)
def test_simulate_matches(scenario):
    want = jsoc.simulate(jsoc.build_soc(JSCEN[scenario]), JM,
                         arrival_rate_ips=200.0, duration_ms=200.0)
    got = tsoc.simulate(tsoc.build_soc(TSCEN[scenario]), TM,
                        arrival_rate_ips=200.0, duration_ms=200.0,
                        device="cpu")
    _hold_metrics(got, want)


@pytest.mark.parametrize("grid", ["paper", "hot"])
def test_simulate_batch_matches(grids, grid):
    want, got, rates = grids[grid]
    _hold_metrics(got, want)
    assert _knees(got["latency_ms"].numpy(), rates) \
        == _knees(want["latency_ms"], rates)
    # the state the metrics come from is bit-equal; only the mean power
    # is summed in another order
    for k in ("completed", "throughput_ips", "energy_mj", "peak_temp_c"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_hot_grid_exercises_migration_and_throttling(grids):
    want, got, _ = grids["hot"]
    ai = SCENARIO_ORDER.index("ai_optimized")
    for res in (want, got):
        migr = np.asarray(res["migrations"])
        thr = np.asarray(res["throttle_ticks"])
        assert (migr[ai] > 0).all()
        assert (np.delete(migr, ai, axis=0) == 0).all()   # reactive designs
        assert (thr > 0).all()
    # the paper's floorplan migrates and throttles nowhere on its grid
    want_p, got_p, _ = grids["paper"]
    for k in COUNTERS:
        assert not np.asarray(want_p[k]).any() and not got_p[k].any()


@pytest.mark.parametrize("hot", [False, True])
def test_perturbed_designs_match_batch_fn(hot):
    """8 designs × 4 rates around ai_optimized, every continuous lifted leaf
    scaled by its own factor in [0.8, 1.2]: the reference's stacked
    SoCParams through its `_batch_fn`, and through `soc_params_from_numpy`
    into the port's."""
    soc_j = jsoc.build_soc(JSCEN["ai_optimized"])
    soc_t = tsoc.build_soc(TSCEN["ai_optimized"])
    if hot:
        soc_j, soc_t = tsoc.hot_variant(soc_j), tsoc.hot_variant(soc_t)
    base = jax.tree.map(np.asarray, jsoc.soc_params(soc_j))
    rng = np.random.default_rng(21 + hot)
    stacked = {}
    for f in dataclasses.fields(base):
        x = getattr(base, f.name)
        scale = rng.uniform(0.8, 1.2, (8, *x.shape)).astype(np.float32)
        stacked[f.name] = (x * scale if f.name in tsoc.CONTINUOUS
                           else np.broadcast_to(x, (8, *x.shape))).copy()
    rates = np.float32([100., 400., 900., 1500.])
    want = jsoc._batch_fn(JM, jsoc._npu_mask(soc_j),
                          jsoc._static_residual(soc_j), 2000, 0.1)(
        jsoc.SoCParams(**{k: jnp.asarray(v) for k, v in stacked.items()}),
        jnp.asarray(rates))
    got = tsoc._batch_fn(TM, tsoc._npu_mask(soc_t),
                         tsoc._static_residual(soc_t), 2000, 0.1)(
        soc_params_from_numpy(jsoc.SoCParams(**stacked)),
        torch.from_numpy(rates))
    _hold_metrics(got, want)
    if hot:
        assert np.asarray(want["migrations"]).all()


def test_scale_designs_matches_numpy():
    p = tsoc.soc_params(tsoc.build_soc(TSCEN["ai_optimized"]), "cpu")
    factors = prng.uniform(prng.key(0), (5, 30), 0.8, 1.2)
    got = tsoc.scale_designs(p, factors)
    f, col = factors.numpy(), 0
    for name in tsoc.CONTINUOUS:
        x = getattr(p, name).numpy()
        width = x.size
        want = x * (f[:, col:col + width] if width > 1 else f[:, col])
        np.testing.assert_array_equal(getattr(got, name).numpy(), want)
        col += width
    assert col == 30
    np.testing.assert_array_equal(got.dvfs_adaptive.numpy(), np.ones(5))


def test_bench_soc_deterministic_fields(grids):
    """`BENCH_soc.json`'s throughput at 200 ips / 200 ms (rtol 1e-5) and
    the 5 ms knees on its 8-rate grid (exactly), from the port."""
    bench = json.loads((ROOT / "BENCH_soc.json").read_text())
    for s in ("basic_chiplet", "ai_optimized"):
        out = tsoc.simulate(tsoc.build_soc(TSCEN[s]), TM,
                            arrival_rate_ips=200.0, duration_ms=200.0,
                            device="cpu")
        _close(float(out["throughput_ips"]), bench[f"{s}_throughput_ips"],
               1e-5)
    _, grid, rates = grids["paper"]
    assert list(rates) == [25., 50., 100., 150., 200., 300., 500., 1000.]
    knees = _knees(grid["latency_ms"].numpy(), PAPER_RATES)
    assert knees == [bench[f"{s}_max_rate_5ms"] for s in SCENARIO_ORDER]
    assert knees == [300.0, 500.0, 200.0, 0.0]


# ------------------------------------------- the paper's claims, on the port
TABLE3 = {
    #                 latency_ms  thpt_ips  power_mw   (±0.2–0.3 ms reported)
    "monolithic":       (4.7,      213.0,    1284.0),
    "basic_chiplet":    (4.8,      208.0,    1026.0),
    "ai_optimized":     (4.1,      244.0,     860.0),
    "poor_integration": (6.2,      163.0,    1776.0),
}


def _predict(scenario, batch=1, workload=TM):
    return tpm.predict(TSCEN[scenario], workload, batch, device="cpu")


def _claim_table3_ordering():
    lats = {s: float(_predict(s).latency_ms) for s in SCENARIO_ORDER}
    pows = {s: float(_predict(s).power_mw) for s in SCENARIO_ORDER}
    assert lats["ai_optimized"] == min(lats.values())
    assert lats["poor_integration"] == max(lats.values())
    assert pows["ai_optimized"] == min(pows.values())
    assert pows["poor_integration"] == max(pows.values())


def _claim_headline_improvements():
    basic, ai = _predict("basic_chiplet"), _predict("ai_optimized")
    lat_drop = 100.0 * (1.0 - float(ai.latency_ms) / float(basic.latency_ms))
    thpt_gain = 100.0 * (float(ai.throughput_ips)
                         / float(basic.throughput_ips) - 1)
    pow_drop = 100.0 * (1.0 - float(ai.power_mw) / float(basic.power_mw))
    eff_gain = 100.0 * (float(ai.tops_per_w) / float(basic.tops_per_w) - 1)
    assert lat_drop == pytest.approx(14.7, abs=2.0)
    assert thpt_gain == pytest.approx(17.3, abs=2.0)
    assert pow_drop == pytest.approx(16.2, abs=3.0)
    assert eff_gain == pytest.approx(40.1, abs=5.0)


def _claim_tops_per_w_absolute():
    assert float(_predict("basic_chiplet").tops_per_w) \
        == pytest.approx(0.203, abs=0.01)
    assert float(_predict("ai_optimized").tops_per_w) \
        == pytest.approx(0.284, abs=0.012)


def _claim_energy_per_inference():
    assert float(_predict("ai_optimized").energy_mj) \
        == pytest.approx(3.5, abs=0.2)


def _claim_fig2b_batch_scaling():
    grid = tpm.predict_grid([TSCEN[s] for s in SCENARIO_ORDER], [TM],
                            [1, 2, 4, 8, 16, 32], device="cpu")
    thpt = grid.throughput_ips[:, 0, :]
    assert bool(torch.all(thpt[:, -1] > thpt[:, 0]))
    ai = SCENARIO_ORDER.index("ai_optimized")
    assert bool(torch.all(thpt[ai, 1:] >= thpt[ai, :-1]))
    for s in range(len(SCENARIO_ORDER)):
        if s != ai:
            assert bool(torch.all(thpt[ai] >= thpt[s]))


def _claim_fig2d_ai_opt_fastest_per_workload():
    for w in WORKLOAD_ORDER:
        lats = {s: float(_predict(s, workload=TWORK[w]).latency_ms)
                for s in SCENARIO_ORDER}
        assert lats["ai_optimized"] == min(lats.values()), w


def _claim_fig2f_realtime_capability():
    assert bool(_predict("ai_optimized", workload=TM).realtime_ok)
    assert bool(_predict("ai_optimized",
                         workload=TWORK["realtime_video"]).realtime_ok)
    assert not bool(_predict("ai_optimized",
                             workload=TWORK["resnet50"]).realtime_ok)


def _claim_throughput_latency_identity():
    for s in SCENARIO_ORDER:
        for b in (1, 4, 32):
            r = _predict(s, batch=b)
            assert float(r.throughput_ips) == pytest.approx(
                1000.0 * b / float(r.latency_ms), rel=1e-5)


def _claim_monolithic_has_no_comm():
    assert float(_predict("monolithic").t_comm_ms) < 1e-6


def _claim_prefetch_overlap_hides_comm():
    ai = _predict("ai_optimized")
    assert float(ai.latency_ms) == pytest.approx(float(ai.t_compute_ms),
                                                 rel=1e-5)
    assert float(ai.t_comm_ms) > 0.0


def _claim_model_is_differentiable():
    v = TSCEN["basic_chiplet"].as_vector("cpu").requires_grad_(True)
    tpm.predict_vec(v, TM.as_vector("cpu"), 1.0).latency_ms.backward()
    assert bool(torch.all(torch.isfinite(v.grad)))
    assert float(v.grad[1]) <= 0.0


CLAIMS = {f.__name__[len("_claim_"):]: f for f in (
    _claim_table3_ordering, _claim_headline_improvements,
    _claim_tops_per_w_absolute, _claim_energy_per_inference,
    _claim_fig2b_batch_scaling, _claim_fig2d_ai_opt_fastest_per_workload,
    _claim_fig2f_realtime_capability, _claim_throughput_latency_identity,
    _claim_monolithic_has_no_comm, _claim_prefetch_overlap_hides_comm,
    _claim_model_is_differentiable)}


@pytest.mark.parametrize("scenario", SCENARIO_ORDER)
def test_paper_claim_table3_reproduction(scenario):
    lat, thpt, power = TABLE3[scenario]
    r = _predict(scenario)
    assert float(r.latency_ms) == pytest.approx(lat, rel=0.06), scenario
    assert float(r.throughput_ips) == pytest.approx(thpt, rel=0.06), scenario
    assert float(r.power_mw) == pytest.approx(power, rel=0.06), scenario


@pytest.mark.parametrize("claim", sorted(CLAIMS))
def test_paper_claim(claim):
    CLAIMS[claim]()


# ------------------------------- the reference's simulate_batch properties
BATCH_RATES = torch.tensor([25., 50., 100., 150., 200., 300., 500., 1000.])
DUR = 50.0


@pytest.fixture(scope="module")
def short_grid():
    socs = [tsoc.build_soc(TSCEN[s]) for s in SCENARIO_ORDER]
    return tsoc.simulate_batch(socs, TM, BATCH_RATES, duration_ms=DUR,
                               device="cpu")


def test_batch_shapes_cover_full_grid(short_grid):
    for key in ("throughput_ips", "latency_ms", "energy_mj", "peak_temp_c"):
        assert short_grid[key].shape == (len(SCENARIO_ORDER), 8), key


@pytest.mark.parametrize("i_scen,i_rate", [(0, 0), (1, 3), (2, 4), (3, 7)])
def test_batch_equals_per_scenario_simulate(short_grid, i_scen, i_rate):
    """`simulate` is the 1 × 1 case of the batched core: equal bit for bit
    (the reference holds its two paths at rel 1e-4)."""
    one = tsoc.simulate(tsoc.build_soc(TSCEN[SCENARIO_ORDER[i_scen]]), TM,
                        arrival_rate_ips=float(BATCH_RATES[i_rate]),
                        duration_ms=DUR, device="cpu")
    for key in one:
        np.testing.assert_array_equal(one[key].numpy(),
                                      short_grid[key][i_scen, i_rate].numpy(),
                                      err_msg=key)


def test_batch_fn_cached_per_static_config():
    socs = [tsoc.build_soc(TSCEN[s]) for s in SCENARIO_ORDER]
    tsoc._batch_fn.cache_clear()
    tsoc.simulate_batch(socs, TM, BATCH_RATES, duration_ms=5.0, device="cpu")
    tsoc.simulate_batch(socs, TM, BATCH_RATES * 1.1, duration_ms=5.0,
                        device="cpu")
    info = tsoc._batch_fn.cache_info()
    assert info.misses == 1 and info.hits == 1, info


def test_stalled_config_reports_inf_latency():
    soc = tsoc.build_soc(TSCEN["ai_optimized"])
    out = tsoc.simulate(soc, TM, arrival_rate_ips=0.0, duration_ms=20.0,
                        device="cpu")
    assert float(out["throughput_ips"]) == 0.0
    assert float(out["latency_ms"]) == float("inf")
    grid = tsoc.simulate_batch([soc], TM, [0.0, 100.0], duration_ms=20.0,
                               device="cpu")
    assert int(torch.argmin(grid["latency_ms"][0])) == 1


def test_params_roundtrip():
    p = tsoc.soc_params(tsoc.build_soc(TSCEN["ai_optimized"]), "cpu")
    leaves = [getattr(p, f.name) for f in dataclasses.fields(p)]
    assert all(isinstance(x, torch.Tensor) for x in leaves)
    p2 = p.map(lambda x: x.clone())
    assert float(p2.efficiency_factor) == pytest.approx(0.90)
    assert float(p2.dvfs_adaptive) == 1.0
    ref = jax.tree.map(np.asarray,
                       jsoc.soc_params(jsoc.build_soc(JSCEN["ai_optimized"])))
    for f in dataclasses.fields(p):
        np.testing.assert_array_equal(getattr(p, f.name).numpy(),
                                      getattr(ref, f.name), err_msg=f.name)
