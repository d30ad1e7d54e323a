"""Port parity, the ssm family: mamba2-780m `.smoke()` (2 layers, d_model
128, 16 SSD heads of 16, state 16, chunk 32, vocab 512) in f32 with the
JAX package's weights, bridged, against `repro/models/ssm.py` and the JAX
engine.

The JAX package asserts S % chunk == 0 once S passes the chunk, so it
cannot prefill 40 or 70 tokens at chunk 32; the port computes a ragged
last chunk. At those lengths the port (chunk 32: 32 + 8, 32 + 32 + 6) is
held to the JAX function run with ssm_chunk = S (one chunk, which it
accepts) and to a float64 sequential recurrence.

Tolerances: f32 against f32 in another summation order, atol = rtol =
1e-4 on logits (std ~0.14) and every cache leaf; the SSD against the f64
recurrence at 2e-3, as the reference's own test holds its chunked form.
Token streams and the engine's counters must equal the JAX engine's
(their top-1 margins are far above 1e-4 on this traffic).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import alloc_cache
from repro_torch.serve.engine import ServeEngine, generate_greedy
from repro_torch.tree import tree_paths

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

ARCH = "mamba2-780m"
TOL = dict(atol=1e-4, rtol=1e-4)
NAIVE_TOL = dict(atol=2e-3, rtol=2e-3)
COUNTERS = ("prefills", "prefill_tokens", "prefill_pad_tokens",
            "decode_steps", "tokens_out", "decode_stall_ticks",
            "occupancy_sum", "decode_compiles", "chunk_compiles")
# the JAX engine prefills only lengths its chunking accepts (<= 32 or a
# multiple of 32); the port's own ragged lengths are held below
ENGINE_LENS = (7, 32, 12, 20, 64, 5)


@pytest.fixture(scope="module")
def case():
    cfg = get_config(ARCH).smoke()
    jm = jbuild(cfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, jp, build_model(cfg, device="cpu"), tp


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _jprompt(seed, n=12, vocab=512):
    """The reference tests' prompts (`tests/test_serve.py:_prompt`)."""
    return np.asarray(
        jax.random.randint(jax.random.key(seed), (n,), 0, vocab), np.int32)


def _np(tree):
    return {k: np.asarray(v, np.float64) if not isinstance(v, torch.Tensor)
            else v.detach().double().numpy()
            for k, v in tree_paths(tree).items()}


def _assert_trees_close(got, want, **tol):
    got, want = _np(got), _np(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


# ------------------------------------------------------------ causal conv1d
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if with_state else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, js = jcommon.causal_conv1d(
        jnp.asarray(x, jdt), jnp.asarray(w),
        state=None if st is None else jnp.asarray(st, jdt))
    ty, ts = tcommon.causal_conv1d(
        torch.as_tensor(x).to(tdt), torch.as_tensor(w),
        state=None if st is None else torch.as_tensor(st).to(tdt))
    assert ty.dtype == ts.dtype == tdt and ts.shape == (2, 3, 24)
    tol = TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), **tol)
    # the new state is the last K-1 inputs, bit for bit
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))


# ---------------------------------------------------------------------- SSD
def _naive_ssd(xh, bt, ct, dt, a):
    """Sequential float64 reference (`tests/test_ssm_rglru.py`):
    h_t = exp(a·dt_t)·h_{t-1} + dt_t·B_t⊗x_t ; y_t = C_t·h_t."""
    b, s, h, p = xh.shape
    n = bt.shape[-1]
    hstate = np.zeros((b, h, p, n), np.float64)
    ys = np.zeros((b, s, h, p), np.float64)
    xh, bt, ct, dt, a = map(lambda t: np.asarray(t, np.float64),
                            (xh, bt, ct, dt, a))
    for t in range(s):
        decay = np.exp(dt[:, t] * a[None, :])               # (b,h)
        outer = np.einsum("bn,bh,bhp->bhpn", bt[:, t], dt[:, t], xh[:, t])
        hstate = decay[:, :, None, None] * hstate + outer
        ys[:, t] = np.einsum("bn,bhpn->bhp", ct[:, t], hstate)
    return ys, hstate


def _ssd_inputs(seed, b=2, s=64, h=3, p=8, n=4):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bt = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    ct = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    return xh, bt, ct, dt, a


def _jax_ssd(inputs, chunk, h0=None):
    cfg = dataclasses.replace(get_config(ARCH).smoke(), ssm_chunk=chunk)
    y, h = jssm._ssd_chunked(*map(jnp.asarray, inputs), cfg,
                             None if h0 is None else jnp.asarray(h0),
                             lambda t, *_: t)
    return np.asarray(y), np.asarray(h)


def _port_ssd(inputs, chunk, h0=None):
    y, h = tssm._ssd_chunked(*map(torch.as_tensor, inputs), chunk,
                             None if h0 is None else torch.as_tensor(h0))
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_jax(chunk):
    """Whole chunks, from a zero state and from a carried one."""
    inputs = _ssd_inputs(chunk)
    h0 = np.random.default_rng(5).standard_normal((2, 3, 8, 4)).astype(
        np.float32)
    for init in (None, h0):
        y, h = _port_ssd(inputs, chunk, init)
        jy, jh = _jax_ssd(inputs, chunk, init)
        np.testing.assert_allclose(y, jy, **TOL)
        np.testing.assert_allclose(h, jh, **TOL)
    y_ref, h_ref = _naive_ssd(*inputs)
    y, h = _port_ssd(inputs, chunk)
    np.testing.assert_allclose(y, y_ref, **NAIVE_TOL)
    np.testing.assert_allclose(h, h_ref, **NAIVE_TOL)


@pytest.mark.parametrize("s", [40, 70])
def test_ssd_ragged_chunk(s):
    """S not a multiple of the chunk: the port's chunks of 32 and a ragged
    last one, against the JAX function at ssm_chunk = S and the f64
    recurrence."""
    inputs = _ssd_inputs(s, s=s)
    with pytest.raises(AssertionError):
        _jax_ssd(inputs, 32)                 # the reference bug
    y, h = _port_ssd(inputs, 32)
    jy, jh = _jax_ssd(inputs, s)
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(h, jh, **TOL)
    y_ref, h_ref = _naive_ssd(*inputs)
    np.testing.assert_allclose(y, y_ref, **NAIVE_TOL)
    np.testing.assert_allclose(h, h_ref, **NAIVE_TOL)


# -------------------------------------------------------------- model level
def test_bridge_carries_the_ssm_tree(case):
    cfg, _, _, tm, tp = case
    mine = tree_paths(tm.init(seed=0))
    got = tree_paths(tp)
    assert sorted(got) == sorted(mine)
    for path, leaf in mine.items():
        assert got[path].shape == leaf.shape and got[path].dtype == leaf.dtype


@pytest.mark.parametrize("s", [7, 32, 64, 40, 70])
def test_prefill_logits_and_state(case, s):
    """Prefill logits and the whole state (h and the three conv states);
    the ragged lengths against the JAX model at ssm_chunk = S."""
    cfg, jm, jp, tm, tp = case
    toks = _tokens(s, (1, s))
    jcfg = cfg if s <= cfg.ssm_chunk or s % cfg.ssm_chunk == 0 \
        else dataclasses.replace(cfg, ssm_chunk=s)
    jl, jc = jbuild(jcfg).prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_trees_close(tc, jc, **TOL)


def test_decode_steps_match_jax(case):
    """Prefill 12 tokens (B = 2), then three decode steps: logits and the
    state after each; the state is written in place."""
    cfg, jm, jp, tm, tp = case
    toks = _tokens(3, (2, 12))
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    _, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    h_storage = tc["h"].data_ptr()
    for step in range(3):
        nxt = _tokens(10 + step, (2, 1))
        jl, jc = jm.decode(jp, {"tokens": jnp.asarray(nxt)}, jc)
        tl, tc = tm.decode(tp, {"tokens": torch.as_tensor(nxt)}, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_trees_close(tc, jc, **TOL)
    assert tc["h"].data_ptr() == h_storage
    assert tc["pos"].tolist() == [15, 15]


def test_decode_continues_prefill(case):
    """A prefill of 30 tokens and decode steps over the next ones give the
    logits a cacheless prefill of each longer prefix ends in (the ragged
    last chunk, 32 + 1 and 32 + 2, included)."""
    cfg, _, _, tm, tp = case
    toks = _tokens(4, (1, 34))
    _, cache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :30])})
    for t in range(30, 34):
        got, cache = tm.decode(
            tp, {"tokens": torch.as_tensor(toks[:, t:t + 1])}, cache)
        want, _ = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :t + 1])})
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_train_loss_matches_jax(case):
    cfg, jm, jp, tm, tp = case
    toks = _tokens(6, (2, 64))
    labels = np.roll(toks, -1, axis=1)
    jl, _ = jm.train_loss(jp, {"tokens": jnp.asarray(toks),
                               "labels": jnp.asarray(labels)})
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    tl, metrics = tm.train_loss(tp, batch, ce_chunk=32)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert metrics["loss"] is tl
    # differentiable: every leaf gets a finite gradient
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tree_paths(tp).items()}
    from repro_torch.tree import tree_from_paths
    loss, _ = tm.train_loss(tree_from_paths(leaves), batch, ce_chunk=32,
                            remat="full")
    loss.backward()
    np.testing.assert_allclose(loss.item(), tl.item(), rtol=1e-6)
    assert all(torch.isfinite(v.grad).all() for v in leaves.values())


def test_cache_shape_is_o1_in_context(case):
    cfg, jm, _, tm, _ = case
    small = tm.cache_shape(4, 64, torch.float32)
    assert small == tm.cache_shape(4, 4096, torch.float32)
    cache = alloc_cache(small, "cpu")
    want = jm.cache_shape(4, 64, jnp.float32)
    got = {k: tuple(v.shape) for k, v in tree_paths(cache).items()}
    want = dict(h=want["h"], conv=dict(want["conv"]), pos=want["pos"])
    assert got == {k: tuple(v.shape) for k, v in tree_paths(want).items()}
    assert cache["h"].dtype == torch.float32


# ------------------------------------------------------------------- engine
def _traffic(sampled):
    reqs = []
    for i, n in enumerate(ENGINE_LENS):
        kw = {}
        if sampled:
            kw = dict(sample_params=(0.8, 20, 0.9) if i % 3 else None,
                      seed=3 + i, rep_penalty=1.3 if i % 2 else 1.0,
                      logit_bias={5: 2.0, 7: -1.5} if i % 3 == 0 else None)
        reqs.append((_tokens(20 + i, n), kw))
    return reqs


def _serve(eng, traffic, new=6):
    reqs = [eng.submit(p, max_new_tokens=new, **kw) for p, kw in traffic]
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], {c: getattr(eng.stats, c)
                                          for c in COUNTERS}


@pytest.mark.parametrize("sampled", [False, True])
def test_engine_matches_jax_engine(case, sampled):
    """Six requests over two slots (slot reuse), greedy, or sampled with a
    repetition penalty and logit bias that apply to the first token (taken
    from the prefill logits): tokens and counters equal the JAX engine's."""
    cfg, jm, jp, tm, tp = case
    traffic = _traffic(sampled)
    want = _serve(JaxEngine(jm, params=jp, n_slots=2, max_len=96), traffic)
    eng = ServeEngine(tm, params=tp, n_slots=2, max_len=96, device="cpu")
    assert not eng.paged and not eng.chunked and not eng.bucket_prompts
    assert _serve(eng, traffic) == want
    assert eng.stats.prefill_pad_tokens == 0


def test_engine_ragged_prompts_match_oracle(case):
    """Prompts the JAX engine cannot prefill (40, 70, 33 tokens) serve,
    each stream equal to the one-slot oracle's."""
    cfg, _, _, tm, tp = case
    prompts = [_tokens(30 + i, n) for i, n in enumerate((40, 70, 33, 9))]
    solo = [generate_greedy(tm, tp, p, 5, max_len=96) for p in prompts]
    eng = ServeEngine(tm, params=tp, n_slots=3, max_len=96, device="cpu")
    assert _serve(eng, [(p, {}) for p in prompts], new=5)[0] == solo


def test_engine_done_at_admission(case):
    """max_new_tokens = 1, or a prompt that fills max_len: the prefill's
    token is the whole stream and the request never takes a decode slot."""
    cfg, _, _, tm, tp = case
    eng = ServeEngine(tm, params=tp, n_slots=1, max_len=32, device="cpu")
    r1 = eng.submit(_tokens(1, 9), max_new_tokens=1)
    r2 = eng.submit(_tokens(2, 32), max_new_tokens=4)
    eng.run_to_completion()
    assert r1.done and r2.done and len(r1.out_tokens) == len(r2.out_tokens) == 1
    assert eng.stats.decode_steps == 0 and eng.stats.tokens_out == 2
    assert r1.out_tokens == generate_greedy(tm, tp, _tokens(1, 9), 1,
                                            max_len=32)


# ------------------------------------------------ the reference's own cases
def test_engine_state_families(case):
    """`tests/test_serve.py::test_engine_state_families` (ssm)."""
    cfg, _, _, tm, tp = case
    solo = generate_greedy(tm, tp, _jprompt(7), n_tokens=4, max_len=64)
    eng = ServeEngine(tm, n_slots=2, max_len=64, params=tp, device="cpu")
    r1 = eng.submit(_jprompt(7), max_new_tokens=4)
    r2 = eng.submit(_jprompt(8), max_new_tokens=4)
    eng.run_to_completion()
    assert r1.out_tokens == solo
    assert len(r2.out_tokens) == 4


def test_state_families_stay_exact(case):
    """`tests/test_serve_fastpath.py::test_state_families_stay_exact`."""
    cfg, _, _, tm, tp = case
    eng = ServeEngine(tm, n_slots=2, max_len=64, params=tp, device="cpu")
    assert not eng.bucket_prompts
    solo = {n: generate_greedy(tm, tp, _jprompt(n, n), n_tokens=3,
                               max_len=64) for n in (7, 12)}
    reqs = {n: eng.submit(_jprompt(n, n), max_new_tokens=3) for n in (7, 12)}
    eng.run_to_completion()
    for n, r in reqs.items():
        assert r.out_tokens == solo[n], (n, r.out_tokens, solo[n])


def test_sampling_recurrent_first_token_path(case):
    """`tests/test_chunked_prefill.py::test_sampling_recurrent_first_token_
    path`: the first token sampled from the prefill logits, the same under
    one seed, greedy at temperature 0."""
    cfg, _, _, tm, tp = case
    greedy = generate_greedy(tm, tp, _jprompt(7, 7), n_tokens=4, max_len=64)
    outs = []
    for _ in range(2):
        eng = ServeEngine(tm, n_slots=1, max_len=64, params=tp, device="cpu")
        r = eng.submit(_jprompt(7, 7), max_new_tokens=4,
                       sample_params=(1.2, 0, 1.0), seed=11)
        eng.run_to_completion()
        outs.append(r.out_tokens)
    assert outs[0] == outs[1]
    eng = ServeEngine(tm, n_slots=1, max_len=64, params=tp, device="cpu")
    r0 = eng.submit(_jprompt(7, 7), max_new_tokens=4)
    eng.run_to_completion()
    assert r0.out_tokens == greedy


@pytest.mark.parametrize("extra", [[], ["--int8"]])
def test_serve_cli_smoke_on_cpu(capsys, extra):
    """`--arch mamba2-780m --smoke --device cpu` serves every request dense;
    `--int8` is the reference CLI's generic QDQ of the 2-D weights with
    f32 state."""
    stats = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "3", "--slots", "2", "--max-len",
                            "64", "--new-tokens", "3"] + extra)
    assert stats.tokens_out == 9 and stats.pages_in_use == 0
    assert "3/3 done" in capsys.readouterr().out
