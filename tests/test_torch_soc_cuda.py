"""The port's SoC simulator on the card, held to its own run on the CPU.

Marked `cuda`: it skips without a GPU. It imports no JAX, so it runs on a
machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_soc_cuda.py

The tick's arithmetic is spelled out so that the card rounds as the CPU does
(`repro_torch.rounding`, `repro_torch.core._batch`): counters and every
state-derived metric are held bit for bit, the mean power (an f64 sum) too.
"""

import pytest
import torch

from repro_torch.core import soc as tsoc
from repro_torch.core.scenarios import SCENARIO_ORDER, SCENARIOS
from repro_torch.core.workloads import MOBILENET_V2

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("hot", [False, True])
def test_simulate_batch_on_card_equals_cpu(card, hot):
    socs = [tsoc.build_soc(SCENARIOS[s]) for s in SCENARIO_ORDER]
    if hot:
        socs = [tsoc.hot_variant(s) for s in socs]
    rates = torch.linspace(25.0, 1500.0, 16)
    cpu = tsoc.simulate_batch(socs, MOBILENET_V2, rates, duration_ms=200.0,
                              device="cpu")
    got = tsoc.simulate_batch(socs, MOBILENET_V2, rates, duration_ms=200.0,
                              device=card)
    for k in cpu:
        assert torch.equal(got[k].cpu(), cpu[k]), k
    if hot:
        assert bool((cpu["migrations"][SCENARIO_ORDER.index("ai_optimized")]
                     > 0).all())


def test_design_sweep_on_card_equals_cpu(card):
    from repro_torch import prng
    soc = tsoc.hot_variant(tsoc.build_soc(SCENARIOS["ai_optimized"]))
    factors = prng.uniform(prng.key(0), (32, 30), 0.8, 1.2)
    designs = tsoc.scale_designs(tsoc.soc_params(soc, "cpu"), factors)
    rates = [100.0, 700.0, 1500.0]
    cpu = tsoc.simulate_designs(soc, designs, MOBILENET_V2, rates,
                                duration_ms=100.0)
    got = tsoc.simulate_designs(soc, designs.map(lambda x: x.to(card)),
                                MOBILENET_V2, rates, duration_ms=100.0)
    for k in cpu:
        assert torch.equal(got[k].cpu(), cpu[k]), k


def test_captured_simulate_batch_equals_eager_on_card(card):
    """The tick loop as replays of a captured block (TICK_BLOCK ticks, a
    per-op lead for the rest) against the same call with `eager=True`:
    every metric bit-equal, at a tick count that does not fill its last
    block and at one that does."""
    socs = [tsoc.hot_variant(tsoc.build_soc(SCENARIOS[s]))
            for s in SCENARIO_ORDER]
    rates = torch.linspace(25.0, 1500.0, 16)
    for dur in (200.0, 5.1):
        got = tsoc.simulate_batch(socs, MOBILENET_V2, rates,
                                  duration_ms=dur, device=card)
        want = tsoc.simulate_batch(socs, MOBILENET_V2, rates,
                                   duration_ms=dur, device=card, eager=True)
        for k in want:
            assert torch.equal(got[k], want[k]), (dur, k)


def test_captured_design_sweep_equals_eager_on_card(card):
    from repro_torch import prng
    soc = tsoc.hot_variant(tsoc.build_soc(SCENARIOS["ai_optimized"]))
    factors = prng.uniform(prng.key(0), (256, 30), 0.8, 1.2)
    designs = tsoc.scale_designs(tsoc.soc_params(soc, card),
                                 factors.to(card))
    rates = [100.0, 700.0, 1500.0]
    got = tsoc.simulate_designs(soc, designs, MOBILENET_V2, rates)
    want = tsoc.simulate_designs(soc, designs, MOBILENET_V2, rates,
                                 eager=True)
    for k in want:
        assert torch.equal(got[k], want[k]), k
