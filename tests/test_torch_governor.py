"""Port parity, the step governor: `repro_torch.train.governor` against
`repro.train.governor` on the reference's governor cases
(tests/test_plans_governor.py::test_governor_translates_plan and the
planner's bottleneck cases), each through both packages' own planner:
equal override dicts and equal states, field for field (pure Python on
both sides, so exactly)."""

import dataclasses

import pytest

from repro.core import planner as jplanner
from repro.train import governor as jgov

from repro_torch.core import planner as tplanner
from repro_torch.train import governor as tgov

# (flops, hbm_bytes, collective_bytes, chips, model_flops): the reference
# governor test's collective-bound cell and the planner test's memory-bound
# one, and a compute-bound cell
TERMS = [(1e15, 1e12, 1e15, 256, 5e14), (1e13, 1e15, 1e11, 256, 5e12),
         (1e18, 1e12, 1e10, 256, 5e17)]
# resident bytes a chip across the planner's remat thresholds (16 GB HBM)
RESIDENT = [None, 4e9, 10e9, 15e9]


def _both(terms):
    return jplanner.RooflineTerms(*terms), tplanner.RooflineTerms(*terms)


def _state(jst, tst):
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)


@pytest.mark.parametrize("terms", TERMS)
@pytest.mark.parametrize("is_training", [True, False])
@pytest.mark.parametrize("resident", RESIDENT)
def test_govern_matches_reference(terms, is_training, resident):
    jt, tt = _both(terms)
    want = jgov.govern(jt, is_training=is_training,
                       resident_bytes_per_chip=resident)
    assert tgov.govern(tt, is_training=is_training,
                       resident_bytes_per_chip=resident) == want
    decision = tplanner.plan(tt, is_training=is_training,
                             resident_bytes_per_chip=resident)
    assert tgov.overrides_from_plan(decision) == want


def test_governor_translates_plan():
    """The reference's case on both packages: a collective-bound training
    cell turns compression on; 50 steps at half the power budget leave
    headroom, which spends itself on fewer microbatches."""
    jt, tt = _both(TERMS[0])
    ov = tgov.govern(tt, is_training=True)
    assert ov == jgov.govern(jt, is_training=True)
    assert ov.get("grad_compression") == "int8"
    jst, tst = jgov.GovernorState(power_budget_w=300.0), \
        tgov.GovernorState(power_budget_w=300.0)
    for _ in range(50):
        jst = jgov.step_governor(jst, simulated_power_w=150.0)
        tst = tgov.step_governor(tst, simulated_power_w=150.0)
        _state(jst, tst)
    assert tst.headroom_ema > 0.3 and tst.steps == 50
    ov = tgov.govern(tt, is_training=True, state=tst)
    assert ov == jgov.govern(jt, is_training=True, state=jst)
    assert ov.get("n_micro_bias") == -1


@pytest.mark.parametrize("alpha", [0.1, 0.5])
def test_step_governor_ema_matches_reference(alpha):
    """The headroom EMA over a power trace that crosses the budget (no
    negative headroom) and a state past the 0.25 threshold and back."""
    trace = [150.0, 290.0, 310.0, 0.0, 75.0, 600.0, 120.0] * 4
    jst, tst = jgov.GovernorState(power_budget_w=250.0), \
        tgov.GovernorState(power_budget_w=250.0)
    jt, tt = _both(TERMS[1])
    seen = set()
    for watts in trace:
        jst = jgov.step_governor(jst, simulated_power_w=watts, alpha=alpha)
        tst = tgov.step_governor(tst, simulated_power_w=watts, alpha=alpha)
        _state(jst, tst)
        seen.add(tst.headroom_ema > 0.25)
        for training in (True, False):
            assert tgov.govern(tt, is_training=training, state=tst) == \
                jgov.govern(jt, is_training=training, state=jst)
    assert seen == {True, False}
