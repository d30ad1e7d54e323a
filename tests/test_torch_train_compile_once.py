"""The compiled train step (`repro_torch.launch.steps.CapturedTrainStep`) on
the CPU, where it runs per op on the static buffers a CUDA graph reads on
the card, against the reference's `jax.jit(make_train_step(...),
donate_argnums=(0,))`: four steps of smollm-360m `.smoke()` (f32,
JAX-initialised weights with the attention projections at their
contraction fan-in, as `tests/test_torch_train.py`) plain and compressed
at n_micro 1 and 2, held at `test_train_step_matches_jax`'s tolerances
after every step; builds equal to the jitted step's `_cache_size()`; the
step counter written in place; a rebound state refused; no host sync
inside a step; one step of every other family bit-equal to the plain
`make_train_step`; `train_loop` with and without `eager`, and resumed. The
card's captures are held to their `eager=True` twins in
`tests/test_torch_train_cuda.py` and `chip_smoke.py` phases 4 and 4b.

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_compile_once.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jdata
from repro.launch import steps as jsteps
from repro.models import ExecOptions, build_model as jbuild
from repro.train import compression as jcomp
from repro.train import optimizer as jopt

from repro_torch.analysis import sanitizer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import train_loop
from repro_torch.models.registry import build_model, train_inputs
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.tree import tree_paths

# one intra-op thread a test process (xdist runs six)
torch.set_num_threads(1)

SEQ, BATCH, STEPS = 32, 4, 4
# `test_train_step_matches_jax`'s schedule: no warmup, lr 1e-3, eps 1e-3
OCFG = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)
VARIANTS = [(False, 1), (False, 2), (True, 1), (True, 2)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(step, seq=SEQ):
    return jdata.TokenSource(jdata.DataConfig(512, seq, BATCH)).batch_at(step)


@pytest.fixture(scope="module")
def smol():
    """JAX-initialised smoke params, attention projections at their
    contraction fan-in (`tests/test_torch_train.py::smol`)."""
    cfg = jget_config("smollm-360m").smoke()
    p = _np_tree(jbuild(cfg, ExecOptions(attn_impl="reference")).init(
        jax.random.key(0)))
    gain = {"wq": cfg.n_heads / cfg.d_model,
            "wk": cfg.n_kv_heads / cfg.d_model,
            "wv": cfg.n_kv_heads / cfg.d_model,
            "wo": 1 / cfg.n_heads}
    p["layers"] = {k: v * np.float32(gain[k] ** 0.5) if k in gain else v
                   for k, v in p["layers"].items()}
    return cfg, p


@pytest.fixture(scope="module")
def jax_runs(smol):
    """{(compress, n_micro): (metrics a step, the state after each step,
    cache sizes after the STEPS calls and after one batch of another
    length)} of the reference's donated, jitted step."""
    cfg, p = smol
    jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=SEQ,
                                 remat="full"))
    runs = {}
    for compress, n_micro in VARIANTS:
        jgt = (lambda g: jcomp.compress_decompress(g)[0]) if compress \
            else None
        jitted = jax.jit(jsteps.make_train_step(
            jm, jopt.OptimizerConfig(**OCFG), jgt, n_micro=n_micro),
            donate_argnums=(0,))
        params = jax.tree.map(jnp.asarray, p)
        state = {"params": params, "opt": jopt.init_opt_state(params)}
        mets, states = [], []
        for step in range(STEPS):
            state, met = jitted(state, {k: jnp.asarray(v) for k, v in
                                        _batch(step).items()})
            mets.append({k: float(v) for k, v in met.items()})
            states.append(_np_tree(state))
        sizes = [jitted._cache_size()]
        if (compress, n_micro) == (False, 1):
            jitted(state, {k: jnp.asarray(v) for k, v in
                           _batch(STEPS, seq=SEQ // 2).items()})
            sizes.append(jitted._cache_size())
        runs[compress, n_micro] = (mets, states, sizes)
    return runs


def _port_step(smol, compress, n_micro, **kw):
    """(the captured step, its state) from the JAX-initialised params."""
    cfg, p = smol
    tm = build_model(cfg, device="cpu")
    tgt = (lambda g: tcomp.compress_decompress(g)[0]) if compress else None
    step_fn = tsteps.make_train_step(tm, topt.OptimizerConfig(**OCFG), tgt,
                                     n_micro=n_micro, ce_chunk=SEQ,
                                     remat="full")
    params = params_from_numpy(p)
    state = {"params": params, "opt": topt.init_opt_state(params)}
    return tsteps.CapturedTrainStep(step_fn, state, **kw), state


def _assert_state_close(got, want, compress):
    """`test_train_step_matches_jax`'s tolerances on params, m and v."""
    lr = OCFG["peak_lr"]
    checks = [("params", got["params"], want["params"], 1e-2 * lr,
               lambda w: 2 * lr),
              ("m", got["opt"]["m"], want["opt"]["m"], 1e-8,
               lambda w: np.abs(w).max() / 127),
              ("v", got["opt"]["v"], want["opt"]["v"], 1e-8,
               lambda w: 3 * np.abs(w).max() / 127)]
    for name, g_tree, w_tree, atol, quantum in checks:
        want_t, got_t = tree_paths(w_tree), tree_paths(g_tree)
        assert set(got_t) == set(want_t)
        for key, w in want_t.items():
            g = got_t[key].numpy()
            off = np.abs(g - w) > atol + 1e-5 * np.abs(w)
            if not compress:
                assert not off.any(), (name, key, np.abs(g - w).max())
                continue
            assert off.sum() <= max(1, off.size // 1000), (name, key)
            assert np.all(np.abs(g - w)[off] <= quantum(w)), (name, key)


def _write_state(state, want):
    """Copy a numpy state into the port's state in place (the addresses the
    step was built on stay)."""
    got, src = tree_paths(state), tree_paths(want)
    for key, t in got.items():
        t.copy_(torch.from_numpy(np.array(src[key])))


@pytest.mark.parametrize("compress,n_micro", VARIANTS)
def test_captured_step_matches_jitted_jax(smol, jax_runs, compress,
                                          n_micro):
    """The four steps run free without compression. With it, each step
    starts from the jitted run's state before it, written in place: one
    step moves a gradient on an int8 block's rounding boundary by a
    quantum (which the one-step tolerance allows), and left to run, that
    moves the later steps' gradients past 1e-5 (step 3's grad_norm by
    2.8e-5 relative)."""
    want_mets, want_states, _ = jax_runs[compress, n_micro]
    step, state = _port_step(smol, compress, n_micro)
    counter = state["opt"]["step"]
    for i in range(STEPS):
        if compress and i:
            _write_state(state, want_states[i - 1])
        state, met = step(state, _batch(i))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), want_mets[i][k],
                                       rtol=1e-5, atol=0,
                                       err_msg=f"step {i} {k}")
        if compress or i == STEPS - 1:
            _assert_state_close(state, want_states[i], compress)
    assert state["opt"]["step"] is counter and int(counter) == STEPS \
        == int(want_states[-1]["opt"]["step"])
    assert step.builds == 1 and step.replays == 0 and not step.captured


def test_builds_equal_the_jitted_cache_size(smol, jax_runs):
    sizes = jax_runs[False, 1][2]
    step, state = _port_step(smol, False, 1)
    with sanitizer.watch() as log:
        for i in range(STEPS):
            state, _ = step(state, _batch(i))
        assert step.builds == sizes[0] == 1
        state, _ = step(state, _batch(STEPS, seq=SEQ // 2))
    assert step.builds == sizes[1] == 2
    assert log.compiles == 2
    # an unlabelled entry: the serving labels' budgets see none of it
    assert not any(log.entry_compiles.values())


def test_rebound_state_raises(smol):
    step, state = _port_step(smol, False, 1)
    state, _ = step(state, _batch(0))
    state["params"]["embed"] = state["params"]["embed"].clone()
    with pytest.raises(RuntimeError, match="rebound"):
        step(state, _batch(1))
    # a state the step was not built on is refused the same way
    _, other = _port_step(smol, False, 1)
    with pytest.raises(RuntimeError, match="rebound"):
        step(other, _batch(1))


@pytest.mark.parametrize("compress,n_micro", [(False, 1), (True, 2)])
def test_no_host_sync_inside_the_steps(smol, compress, n_micro):
    step, state = _port_step(smol, compress, n_micro)
    with sanitizer.compile_budget(total=1, host_syncs=0) as log:
        for i in range(3):
            state, met = step(state, _batch(i))
    assert log.compiles == 1 and log.host_syncs == 0
    assert np.isfinite(float(met["loss"]))


# every family beyond the dense one: (arch, seq), the parity tests' lengths
FAMILIES = [("qwen2-moe-a2.7b", 32), ("deepseek-v2-lite", 32),
            ("llava-next-mistral-7b", 32), ("seamless-m4t-medium", 32),
            ("mamba2-780m", 64), ("recurrentgemma-2b", 96)]


@pytest.mark.parametrize("arch,seq", FAMILIES)
def test_family_step_bit_equal_to_plain_step(arch, seq):
    """One compressed step at n_micro 2 through the wrapper equals the
    plain `make_train_step` on the same state bit for bit: the family's
    float inputs (vlm patch rows, encdec frames; `registry.train_inputs`,
    bf16 tensors) through the static buffers' tensor copies."""
    cfg = get_config(arch).smoke()
    opts, kw = tsteps.train_options(seq)
    model = build_model(cfg, opts, device="cpu")
    batch = train_inputs(cfg, BATCH, seq, seed=3, device="cpu")
    assert {"patch_embeds", "frames"} & set(batch) or cfg.family not in (
        "vlm", "encdec")
    params = model.init(0)
    states = [{"params": _clone(params), "opt": topt.init_opt_state(params)}
              for _ in range(2)]
    step_fn = tsteps.make_train_step(
        model, topt.OptimizerConfig(**OCFG), tcomp.compress_grads,
        n_micro=2, **kw)
    want, want_met = step_fn(states[0], batch)
    step = tsteps.CapturedTrainStep(step_fn, states[1])
    got, got_met = step(states[1], batch)
    for k in ("loss", "grad_norm", "lr"):
        assert torch.equal(got_met[k], want_met[k]), k
    w, g = tree_paths(want), tree_paths(got)
    assert set(w) == set(g)
    for key in w:
        assert torch.equal(g[key], w[key]), key
    assert step.builds == 1


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


LOOP = dict(arch="smollm-360m", smoke=True, global_batch=BATCH, seq_len=SEQ,
            ckpt_every=0, log_every=100, device="cpu")


def _loop(ckpt_dir, steps, **kw):
    with sanitizer.watch() as log:
        losses, state = train_loop(steps=steps, ckpt_dir=str(ckpt_dir),
                                   **LOOP, **kw)
    return losses, state, log.compiles


@pytest.mark.parametrize("compress", [False, True])
def test_train_loop_eager_twin_and_resume(tmp_path, compress):
    losses, state, builds = _loop(tmp_path / "a", 4, compress_grads=compress)
    e_losses, e_state, e_builds = _loop(tmp_path / "b", 4, eager=True,
                                        compress_grads=compress)
    assert builds == e_builds == 1
    assert losses == e_losses and len(losses) == 4
    a, b = tree_paths(state), tree_paths(e_state)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    # two steps, then a resume to four: one build, the same losses
    first, _, _ = _loop(tmp_path / "c", 2, compress_grads=compress)
    resumed, r_state, r_builds = _loop(tmp_path / "c", 4,
                                       compress_grads=compress)
    assert r_builds == 1
    assert first + resumed == losses
    r = tree_paths(r_state)
    assert all(torch.equal(r[k], a[k]) for k in a)
