"""The captured train step (`repro_torch.launch.steps.CapturedTrainStep`) on
the card, held to its `eager=True` twin bit for bit: three steps of the
dense, moe and vlm families' `.smoke()` (f32, the train shape's options,
inputs from `registry.train_inputs`: vlm patch rows as a float tensor),
plain and compressed, n_micro 2. The first step builds and the next two
replay the CUDA graph; the compressed step's quantizer launches count
leaves x steps through the replays. A step that raises while it is
captured leaves no stream capturing and the step unbuilt.

Marked `cuda`: it skips without a GPU. It imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_cuda.py
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import quantize as kq
from repro_torch.launch import steps as tsteps
from repro_torch.models.registry import build_model, train_inputs
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.tree import tree_paths

pytestmark = pytest.mark.cuda

OCFG = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)
STEPS, BATCH, SEQ = 3, 4, 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _run(model, batch, kw, compress, eager):
    """STEPS steps from seed 0's state; (losses, metrics, state, step,
    quantizer launches)."""
    params = model.init(0)
    state = {"params": params, "opt": topt.init_opt_state(params)}
    step_fn = tsteps.make_train_step(
        model, topt.OptimizerConfig(**OCFG),
        tcomp.compress_grads if compress else None, n_micro=2, **kw)
    step = tsteps.CapturedTrainStep(step_fn, state, eager=eager)
    kq.LAUNCHES.clear()
    losses, mets = [], []
    for _ in range(STEPS):
        state, met = step(state, batch)
        # read before the next replay overwrites them
        mets.append({k: v.clone() for k, v in met.items()})
        losses.append(float(met["loss"]))
    torch.cuda.synchronize()
    return losses, mets, state, step, dict(kq.LAUNCHES)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-moe-a2.7b",
                                  "llava-next-mistral-7b"])
def test_captured_step_equals_eager_twin(card, arch, compress):
    cfg = get_config(arch).smoke()
    opts, kw = tsteps.train_options(SEQ)
    model = build_model(cfg, opts, device=card)
    batch = train_inputs(cfg, BATCH, SEQ, seed=1, device=card,
                         dtype=torch.float32)
    got = _run(model, batch, kw, compress, eager=False)
    want = _run(model, batch, kw, compress, eager=True)
    losses, mets, state, step, launches = got
    assert step.captured and step.builds == 1 and step.replays == STEPS - 1
    assert want[3].builds == 1 and want[3].replays == 0
    assert losses == want[0]
    for m, w in zip(mets, want[1]):
        assert all(torch.equal(m[k], w[k]) for k in w)
    a, b = tree_paths(state), tree_paths(want[2])
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert int(state["opt"]["step"]) == STEPS
    leaves = len(tree_paths(state["params"]))
    n = leaves * STEPS if compress else 0
    assert launches == want[4] and launches.get("quantize_blocks", 0) == n \
        and launches.get("dequantize_blocks", 0) == n


def test_failed_capture_leaves_nothing_capturing(card):
    cfg = get_config("smollm-360m").smoke()
    model = build_model(cfg, tsteps.train_options(SEQ)[0], device=card)
    params = model.init(0)
    state = {"params": params, "opt": topt.init_opt_state(params)}

    def step_fn(state, batch):
        loss = batch["tokens"].float().mean()
        if torch.cuda.is_current_stream_capturing():
            raise ValueError("planted failure under capture")
        return state, {"loss": loss}

    step = tsteps.CapturedTrainStep(step_fn, state)
    batch = train_inputs(cfg, BATCH, SEQ, seed=1, device=card)
    with pytest.raises(ValueError, match="planted"):
        step(state, batch)
    assert not torch.cuda.is_current_stream_capturing()
    assert step.builds == 0 and not step.captured
    assert float(torch.ones(8, device=card).sum()) == 8.0
