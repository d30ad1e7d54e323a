"""Port parity, sampling: `repro_torch.prng` against `jax.random` (JAX's
default threefry key with `jax_threefry_partitionable` on),
`repro_torch.serve.sampling` against `repro/serve/sampling.py`, and the
port's engine against the JAX engine on the reference's sampling and
logit-processor cases (`tests/test_chunked_prefill.py`,
`tests/test_logit_processors.py`), smollm-360m `.smoke()` in f32 with
JAX-initialised weights bridged to torch.

Tolerances: key data, `fold_in`, bits and uniform are bit-equal. A Gumbel
score is `-log(-log(u))` of a bit-equal u; `log` may round an ulp apart in
the two frameworks, and the outer log turns one ulp of its argument near 1
into an absolute error of about one ulp of 1, so scores are held within 2
ulps of max(|g|, 1). Sampled tokens are equal."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ExecOptions, build_model as jbuild
from repro.serve import sampling as jsampling
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch import prng
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve import sampling
from repro_torch.serve.engine import ServeEngine, generate_greedy

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

SEEDS = (0, 1, 7, -1, -123456, 2 ** 31 - 1, 987654321)
COUNTERS = (0, 1, 2, 31, 1000, 9999, 10000)


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_threefry_key_and_fold_in_bit_equal():
    for seed in SEEDS:
        k = jax.random.key(seed)
        tk = prng.key(seed)
        np.testing.assert_array_equal(tk.numpy(), _kd(k))
        for c in COUNTERS:
            np.testing.assert_array_equal(
                prng.fold_in(tk, c).numpy(), _kd(jax.random.fold_in(k, c)))
    # batched: a (B,) seed tensor and a (B,) counter tensor
    seeds = torch.tensor(SEEDS, dtype=torch.int64)
    ctr = torch.tensor(COUNTERS, dtype=torch.int64)
    want = np.stack([_kd(jax.random.fold_in(jax.random.key(s), c))
                     for s, c in zip(SEEDS, COUNTERS)])
    np.testing.assert_array_equal(
        prng.fold_in(prng.key(seeds), ctr).numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 511, 4096])
def test_bits_and_uniform_bit_equal(n):
    for seed in SEEDS:
        for c in (0, 3, 10000):
            k = jax.random.fold_in(jax.random.key(seed), c)
            tk = prng.fold_in(prng.key(seed), c)
            want = np.asarray(jax.random.bits(k, (n,))).astype(np.int64)
            np.testing.assert_array_equal(prng.bits(tk, n).numpy(), want)
            for lo, hi in ((0.0, 1.0), (float(jnp.finfo(jnp.float32).tiny),
                                        1.0)):
                u = np.array(jax.random.uniform(k, (n,), minval=lo,
                                                maxval=hi))
                got = prng.uniform(tk, n, lo, hi).numpy()
                np.testing.assert_array_equal(got.view(np.int32),
                                              u.view(np.int32))


def test_gumbel_within_two_ulps():
    for seed in SEEDS:
        for c in (0, 5, 9999):
            k = jax.random.fold_in(jax.random.key(seed), c)
            want = np.array(jax.random.gumbel(k, (4096,)), np.float64)
            got = prng.gumbel(prng.fold_in(prng.key(seed), c), 4096).numpy()
            ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
            assert np.all(np.abs(got - want) <= 2 * ulp), seed


def test_categorical_tokens_equal():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((200, 384)) * 2).astype(np.float32)
    seeds = rng.integers(-2 ** 31, 2 ** 31 - 1, 200)
    ctr = rng.integers(0, 10_000, 200)
    want = [int(jax.random.categorical(
        jax.random.fold_in(jax.random.key(int(s)), int(c)), logits[i]))
        for i, (s, c) in enumerate(zip(seeds, ctr))]
    keys = prng.fold_in(prng.key(torch.from_numpy(seeds)),
                        torch.from_numpy(ctr))
    got = prng.categorical(keys, torch.from_numpy(logits))
    assert got.tolist() == want


def _jax_sample(logits, params, seeds, ctr):
    return np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray([p[0] for p in params], jnp.float32),
        jnp.asarray([p[1] for p in params], jnp.int32),
        jnp.asarray([p[2] for p in params], jnp.float32),
        jnp.asarray(seeds, jnp.int32), jnp.asarray(ctr, jnp.int32)))


def _torch_sample(logits, params, seeds, ctr):
    return sampling.sample_tokens(
        torch.from_numpy(logits),
        torch.tensor([p[0] for p in params], dtype=torch.float32),
        torch.tensor([p[1] for p in params], dtype=torch.int32),
        torch.tensor([p[2] for p in params], dtype=torch.float32),
        torch.tensor(seeds, dtype=torch.int32),
        torch.tensor(ctr, dtype=torch.int32)).numpy()


EDGE_PARAMS = [(-2.0, 0, 1.0), (0.7, 64 + 9, 1.0), (0.7, 0, 0.0),
               (0.7, 3, 0.0), (1e-9, 1, 1e-9), (float("nan"), 5, 0.5),
               (0.9, 5, float("nan")), (0.0, 40, 0.95), (0.8, 40, 0.95),
               (1.3, 0, 0.9), (0.8, 1, 1.0), (2.0, 64, 0.3)]


@pytest.mark.parametrize("ties", [False, True])
def test_sample_tokens_matches_jax(ties):
    """The reference's edge cases (`tests/test_chunked_prefill.py`: negative
    temperature, top_k >= vocab, top_p 0, all tiny, NaN parameters) and
    ordinary ones, on random logits and on logits with ties (values from a
    coarse grid, so top-k cuts and argmax fall between equal logits)."""
    v = 64
    rng = np.random.default_rng(1 + ties)
    logits = rng.standard_normal((len(EDGE_PARAMS), v)).astype(np.float32)
    if ties:
        logits = np.round(logits * 2) / 2
    params = [sampling.clamp_sample_params(*p) for p in EDGE_PARAMS]
    assert params == [jsampling.clamp_sample_params(*p) for p in EDGE_PARAMS]
    for trial in range(4):
        seeds = rng.integers(-1000, 1000, len(params))
        ctr = rng.integers(0, 500, len(params))
        want = _jax_sample(logits, params, seeds, ctr)
        got = _torch_sample(logits, params, seeds, ctr)
        np.testing.assert_array_equal(got, want)
    arg = np.argmax(logits, axis=-1)
    assert got[0] == arg[0] and got[2] == arg[2] and got[3] == arg[3]


def test_sample_tokens_matches_jax_at_vocab_width():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((8, 49152)) * 0.6).astype(np.float32)
    params = [(0.8, 40, 0.95)] * 4 + [(1.0, 0, 1.0), (0.0, 0, 1.0),
                                       (0.5, 0, 0.9), (1.2, 100, 1.0)]
    seeds, ctr = np.arange(100, 108), np.arange(8) * 5
    np.testing.assert_array_equal(_torch_sample(logits, params, seeds, ctr),
                                  _jax_sample(logits, params, seeds, ctr))


def test_clamps_and_processors_match_jax():
    for p in (float("nan"), 0.0, -2.5, 0.5, 1.3, 1, 1e9):
        got, want = sampling.clamp_rep_penalty(p), \
            jsampling.clamp_rep_penalty(p)
        assert got == pytest.approx(want) and isinstance(got, float)
    assert sampling.clamp_rep_penalty(float("nan")) == 1.0
    logits = np.asarray([[2.0, -2.0, 4.0, -4.0], [2.0, -2.0, 4.0, -4.0]],
                        np.float32)
    seen = np.asarray([[True, True, False, False]] * 2)
    for pen in ([2.0, 1.0], [0.5, 0.5], [1.3, 1e9]):
        bias = np.zeros((2, 4), np.float32)
        bias[0, 3] = 10.0
        want = np.asarray(jsampling.apply_logit_processors(
            jnp.asarray(logits), jnp.asarray(pen, jnp.float32),
            jnp.asarray(seen), jnp.asarray(bias)))
        got = sampling.apply_logit_processors(
            torch.from_numpy(logits), torch.tensor(pen), torch.from_numpy(seen),
            torch.from_numpy(bias)).numpy()
        np.testing.assert_array_equal(got, want)
    out = sampling.apply_logit_processors(
        torch.from_numpy(logits), torch.tensor([2.0, 1.0]),
        torch.from_numpy(seen), torch.zeros(2, 4)).numpy()
    np.testing.assert_array_equal(out[1], logits[1])


# ------------------------------------------------------------- engine level
@pytest.fixture(scope="module")
def smol():
    cfg = get_config("smollm-360m").smoke()
    jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=32))
    jp = jm.init(jax.random.key(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, jp, build_model(cfg, device="cpu"), tp


def _prompt(seed, n, vocab=512):
    return np.asarray(
        jax.random.randint(jax.random.key(seed), (n,), 0, vocab), np.int32)


def _run_both(smol, submissions, **engine_kw):
    """Submit `submissions` [(prompt, kwargs)] to a JAX and a port engine
    (n_slots 2, max_len 64, page 8 unless overridden), run both to
    completion and hold the port's streams to the JAX engine's. Returns the
    port's requests."""
    cfg, jm, jp, tm, tp = smol
    kw = dict(n_slots=2, max_len=64, page_size=8)
    kw.update(engine_kw)
    je = JaxEngine(jm, params=jp, **kw)
    te = ServeEngine(tm, params=tp, device="cpu", **kw)
    jr = [je.submit(p, **a) for p, a in submissions]
    tr = [te.submit(p, **a) for p, a in submissions]
    je.run_to_completion()
    te.run_to_completion()
    for a, b in zip(jr, tr):
        assert b.out_tokens == a.out_tokens, (a.rid, a.out_tokens,
                                              b.out_tokens)
    for name in ("decode_steps", "tokens_out", "prefill_chunks",
                 "prefix_hits", "prefix_hit_tokens", "decode_compiles",
                 "chunk_compiles"):
        assert getattr(te.stats, name) == getattr(je.stats, name), name
    return tr


def test_sampling_deterministic_and_temp0_is_greedy(smol):
    cfg, jm, jp, tm, tp = smol
    greedy = generate_greedy(tm, tp, _prompt(3, 9), n_tokens=6, max_len=64)
    p = _prompt(3, 9)
    r1, r2, r0 = _run_both(smol, [
        (p, dict(max_new_tokens=6, sample_params=(0.8, 20, 0.9), seed=7)),
        (p, dict(max_new_tokens=6, sample_params=(0.8, 20, 0.9), seed=7)),
        (p, dict(max_new_tokens=6, sample_params=(0.0, 0, 1.0), seed=3))])
    assert r1.out_tokens == r2.out_tokens
    assert r0.out_tokens == greedy
    assert r1.out_tokens != greedy
    (r3,) = _run_both(smol, [(p, dict(max_new_tokens=6,
                                      sample_params=(0.8, 20, 0.9), seed=7))],
                      n_slots=1)
    assert r3.out_tokens == r1.out_tokens


def test_degenerate_sample_params_clamp(smol):
    cfg = smol[0]
    p = _prompt(3, 9)
    greedy = generate_greedy(smol[3], smol[4], p, n_tokens=4, max_len=64)
    r_neg, r_p0, r_kbig, r_k0 = _run_both(smol, [
        (p, dict(max_new_tokens=4, sample_params=(-1.0, 0, 1.0))),
        (p, dict(max_new_tokens=4, sample_params=(0.8, 0, 0.0), seed=5)),
        (p, dict(max_new_tokens=4,
                 sample_params=(0.8, cfg.vocab_size + 7, 1.0), seed=9)),
        (p, dict(max_new_tokens=4, sample_params=(0.8, 0, 1.0), seed=9))])
    assert r_neg.out_tokens == greedy
    assert r_p0.out_tokens == greedy
    assert r_kbig.out_tokens == r_k0.out_tokens


def test_identity_processors_stay_greedy_exact(smol):
    p = _prompt(3, 9)
    greedy = generate_greedy(smol[3], smol[4], p, n_tokens=6, max_len=64)
    r_nan, r_eps = _run_both(smol, [
        (p, dict(max_new_tokens=6, rep_penalty=float("nan"))),
        (p, dict(max_new_tokens=6, rep_penalty=1.0 + 1e-12))])
    assert r_nan.out_tokens == greedy
    assert r_eps.out_tokens == greedy


def test_rep_penalty_output_matches_jax(smol):
    """The reference's `test_rep_penalty_changes_repeating_output` fails in
    the reference itself (ROADMAP C); the port is held to what the JAX
    engine outputs for the same submissions, greedy under a huge penalty
    and the plain greedy stream beside it (on these weights the two are
    equal: the greedy stream repeats no token, so the penalty never
    changes an argmax)."""
    p = _prompt(9, 9)
    r, g = _run_both(smol, [(p, dict(max_new_tokens=8, rep_penalty=1e9)),
                            (p, dict(max_new_tokens=8))])
    assert len(r.out_tokens) == 8
    assert not set(r.out_tokens) & set(int(t) for t in p)


def test_logit_bias_forces_and_bans_tokens(smol):
    p = _prompt(3, 9)
    greedy = generate_greedy(smol[3], smol[4], p, n_tokens=4, max_len=64)
    r_force, r_force_s, r_ban = _run_both(smol, [
        (p, dict(max_new_tokens=4, logit_bias={42: 1e9})),
        (p, dict(max_new_tokens=4, logit_bias={42: 1e9},
                 sample_params=(0.8, 5, 0.9), seed=7)),
        (p, dict(max_new_tokens=4, logit_bias={greedy[0]: -1e9}))],
        n_slots=3)
    assert r_force.out_tokens == [42] * 4
    assert r_force_s.out_tokens == [42] * 4
    assert greedy[0] not in r_ban.out_tokens


def test_rep_penalty_sampled_determinism(smol):
    p = _prompt(3, 9)
    sub = (p, dict(max_new_tokens=6, sample_params=(0.9, 20, 0.95), seed=11,
                   rep_penalty=1.4))
    (a,) = _run_both(smol, [sub], n_slots=1)
    (b,) = _run_both(smol, [sub], n_slots=1)
    assert a.out_tokens == b.out_tokens


def test_mixed_batch_is_order_independent(smol):
    """Greedy, sampled, penalized and biased requests in one batch: the
    JAX engine's streams, and the same streams in reverse submission
    order on a fresh engine."""
    subs = [(_prompt(40 + i, 5 + 3 * i),
             dict(max_new_tokens=5, seed=100 + i,
                  sample_params=(0.8, 40, 0.95) if i % 2 else None,
                  rep_penalty=1.3 if i == 2 else 1.0,
                  logit_bias={7: 2.5} if i == 4 else None))
            for i in range(6)]
    fwd = _run_both(smol, subs, n_slots=3)
    rev = _run_both(smol, subs[::-1], n_slots=3)
    assert [r.out_tokens for r in fwd] == [r.out_tokens for r in rev[::-1]]


def test_logit_bias_validation(smol):
    cfg, _, _, tm, tp = smol
    eng = ServeEngine(tm, n_slots=1, max_len=64, params=tp, page_size=8,
                      device="cpu")
    for bad in ({-1: 1.0}, {cfg.vocab_size: 1.0},
                {3: float("inf")}, {3: float("nan")}):
        with pytest.raises(ValueError):
            eng.submit(_prompt(3, 9), max_new_tokens=2, logit_bias=bad)
    r = eng.submit(_prompt(3, 9), max_new_tokens=2, rep_penalty=-3.0)
    eng.run_to_completion()
    assert r.done and math.isfinite(sum(r.out_tokens))


def test_serve_cli_sampling_and_prefix_flags(capsys):
    """`--temperature/--top-k/--top-p` sample every request (request i with
    seed `--seed` + i, so two runs emit the same tokens); `--no-prefix-cache`
    turns the cache off."""
    from repro_torch.launch import serve as serve_cli
    args = ["--smoke", "--device", "cpu", "--requests", "4", "--slots", "2",
            "--max-len", "64", "--new-tokens", "4", "--page-size", "8",
            "--temperature", "0.8", "--top-k", "40", "--top-p", "0.95"]
    a = serve_cli.main(args)
    b = serve_cli.main(args + ["--no-prefix-cache"])
    assert a.tokens_out == b.tokens_out == 16
    assert b.prefix_misses == 0 and a.prefix_misses == 4
    assert "4/4 done" in capsys.readouterr().out
