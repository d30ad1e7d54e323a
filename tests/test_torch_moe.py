"""Port parity, moe family: `repro_torch.models.moe` and the qwen2-moe-a2.7b
paths that reach it, against `repro/models/moe.py` and the JAX engine on the
same numpy-seeded inputs and JAX-initialised weights (`.smoke()`: 8 experts
top-2, d_ff_expert 64, moe_group 64, shared expert 128, f32).

Covered: the copied config; `router_topk` (forced ties break to the lower
expert index, as `jax.lax.top_k`), `capacity`, `make_dispatch` (forced
drops), `moe_ffn` with and without the shared expert and with drops;
`load_balance_loss`; the expert-batched `qeinsum` against JAX's Pallas
kernel (interpret mode) and its jnp path; `quantize_params`' per-expert
scales bit for bit; prefill logits; the chunked paged engine against
`generate_greedy` and the JAX engine, and the int8 engine against its dense
int8 oracle; the engine-grouped teacher-forced replay
(`serve.moe_replay`), with its own routing and with the engine's, against
the engine's own logits.

Tolerance: f32 1e-5 unless stated (summation order across the two
frameworks); quantized outputs 1e-5 relative to their largest value."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jcfg
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.models.quantized import qeinsum as jqeinsum
from repro.models.transformer import ExecOptions as JaxOpts
from repro.models.quantized import quantize_params as jquantize
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.train import train_loop
from repro_torch.models import moe
from repro_torch.models import transformer
from repro_torch.models.quantized import qeinsum, quantize_params
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine, generate_greedy
from repro_torch.serve.moe_replay import (
    engine_replay, engine_routes, moe_teacher_forced_segments,
    recorded_routes, teacher_forced_pass)

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

ARCH = "qwen2-moe-a2.7b"
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture(scope="module")
def qmoe():
    cfg = get_config(ARCH).smoke()
    jm = jbuild(jcfg(ARCH).smoke())
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, jp, build_model(cfg, device="cpu"), tp


def _layer(params, i=0):
    return {k: v[i] for k, v in params["layers"].items()}


def test_config_matches_reference():
    """The copied config and its `smoke()` equal the reference field for
    field (smoke: 8 experts, top-2, d_ff_expert 64, moe_group 64, d_ff_shared
    128)."""
    for full in (True, False):
        want = jcfg(ARCH) if full else jcfg(ARCH).smoke()
        got = get_config(ARCH) if full else get_config(ARCH).smoke()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    s = get_config(ARCH).smoke()
    assert (s.n_experts, s.moe_top_k, s.d_ff_expert, s.moe_group,
            s.d_ff_shared) == (8, 2, 64, 64, 128)


@pytest.mark.parametrize("ties", [False, True])
def test_router_topk_matches_jax(ties):
    """Random logits, and logits with forced ties (bf16-rounded values from
    a few levels, many experts equal at the top-k edge): the same experts
    in the same order and the same renormalized gates."""
    logits = _np((3, 17, 60), 1)
    if ties:
        logits = np.round(logits * 2) / 2        # 60 experts on ~9 levels
        logits[:, :, 10:14] = logits[:, :, 20:24] = 2.0
    for k in (1, 2, 4):
        jp, ji = jmoe.router_topk(jnp.asarray(logits), k)
        tp, ti = moe.router_topk(_t(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    if ties:   # the tie at the edge went to the lower index
        _, ti = moe.router_topk(_t(logits), 4)
        assert ti[0, 0].tolist() == [10, 11, 12, 13]


@pytest.mark.parametrize("gs", [1, 9, 16, 64, 512, 1024])
def test_capacity_matches_jax(gs):
    for arch in (ARCH, "dbrx-132b", "deepseek-v2-lite"):
        for cfg, jc in ((get_config(arch), jcfg(arch)),
                        (get_config(arch).smoke(), jcfg(arch).smoke())):
            assert moe.capacity(cfg, gs) == jmoe.capacity(jc, gs)
    assert moe.capacity(get_config(ARCH), 64) == 8
    assert moe.capacity(get_config(ARCH), 512) == 48


@pytest.mark.parametrize("forced_drops", [False, True])
def test_make_dispatch_matches_jax(forced_drops):
    """Dispatch and combine tensors equal JAX's bit for bit; with every
    token on expert 3 first, capacity 8 of 24 tokens drops the last 16."""
    rng = np.random.default_rng(2)
    g, s, k, e, cap = 2, 24, 2, 8, 8
    idx = np.stack([rng.permutation(e)[:k] for _ in range(g * s)]
                   ).reshape(g, s, k).astype(np.int32)
    if forced_drops:
        idx[:, :, 0] = 3
        idx[:, :, 1] = np.where(idx[:, :, 1] == 3, 4, idx[:, :, 1])
    p = rng.random((g, s, k)).astype(np.float32)
    jd, jc = jmoe.make_dispatch(jnp.asarray(p), jnp.asarray(idx), e, cap)
    td, tc = moe.make_dispatch(_t(p), _t(idx), e, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if forced_drops:
        assert td[:, :, 3].sum().item() == g * cap
        assert td[:, cap:, 3].sum().item() == 0


@pytest.mark.parametrize("shared,drops", [(True, False), (False, False),
                                          (True, True)])
def test_moe_ffn_matches_jax(qmoe, shared, drops):
    """One layer's MoE FFN on (2, 64) tokens: with the shared expert, without
    it, and with capacity_factor 0.25 (capacity 8 for 128 assignments a
    group of 64 over 8 experts: late tokens lose both their experts)."""
    cfg, _, jp, _, tp = qmoe
    jc = jcfg(ARCH).smoke()
    kw = {}
    if not shared:
        kw["d_ff_shared"] = 0
    if drops:
        kw.update(capacity_factor=0.25)
    cfg, jc = dataclasses.replace(cfg, **kw), dataclasses.replace(jc, **kw)
    lp = _layer(tp)
    jlp = {k: v[0] for k, v in jp["layers"].items()}
    if not shared:
        lp = {k: v for k, v in lp.items() if not k.startswith("shared")}
        jlp = {k: v for k, v in jlp.items() if not k.startswith("shared")}
    x = _np((2, 64, cfg.d_model), 3)
    want = np.asarray(jmoe.moe_ffn(jnp.asarray(x), jlp, jc))
    got = moe.moe_ffn(_t(x), lp, cfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if drops:     # the drops are real: some routed output rows are zero
        lp0 = {k: v for k, v in lp.items() if not k.startswith("shared")}
        routed = moe.moe_ffn(_t(x), lp0, dataclasses.replace(
            cfg, d_ff_shared=0)).numpy()
        assert (np.abs(routed).max(-1) == 0).any()


def test_load_balance_loss_matches_jax():
    logits = _np((4, 16, 8), 5)
    _, idx = jmoe.router_topk(jnp.asarray(logits), 2)
    want = float(jmoe.load_balance_loss(jnp.asarray(logits), idx, 8))
    got = float(moe.load_balance_loss(_t(logits), _t(np.asarray(idx)), 8))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("eq,xshape,wkey", [
    ("egcd,edf->egcf", (8, 2, 8, 128), "w1"),
    ("egcf,efd->egcd", (8, 2, 8, 64), "w2")])
def test_batched_qeinsum_matches_jax(qmoe, eq, xshape, wkey):
    """The expert-batched pattern: the port's `int8_matmul_batched` (its
    plain version on the CPU) against JAX's vmapped Pallas kernel in
    interpret mode and its jnp path, on the per-expert quantized smoke
    weights."""
    cfg, _, jp, _, _ = qmoe
    jq = jquantize(jp, jcfg(ARCH).smoke())["layers"][wkey]
    jw = {k: v[0] for k, v in jq.items()}
    tw = params_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    x = _np(xshape, 6)
    got = qeinsum(eq, _t(x), tw).numpy()
    big = np.abs(got).max()
    for impl, kw in (("pallas", dict(interpret=True)), ("jnp", {})):
        want = np.asarray(jqeinsum(eq, jnp.asarray(x), jw, impl=impl, **kw))
        assert want.shape == got.shape
        np.testing.assert_allclose(got, want, atol=1e-5 * big, rtol=0)


def test_quantize_params_per_expert_bit_equal(qmoe):
    """Routed experts per expert over axis 2, shared over axis 1, the
    attention as for dense: every int8 value and scale equals JAX's; the
    router, the shared gate, norms and biases stay float."""
    cfg, _, jp, _, tp = qmoe
    jq = jquantize(jp, jcfg(ARCH).smoke())["layers"]
    tq = quantize_params(tp, cfg)["layers"]
    for key in ("wq", "wk", "wv", "wo", "w1", "w3", "w2", "shared_w1",
                "shared_w3", "shared_w2"):
        np.testing.assert_array_equal(tq[key]["int8_q"].numpy(),
                                      np.asarray(jq[key]["int8_q"]))
        np.testing.assert_array_equal(tq[key]["s"].numpy(),
                                      np.asarray(jq[key]["s"]))
    assert tq["w1"]["s"].shape == (cfg.n_layers, cfg.n_experts, 1,
                                   cfg.d_ff_expert)
    for key in ("router", "shared_gate", "attn_norm", "bq"):
        assert isinstance(tq[key], torch.Tensor), key


@pytest.mark.parametrize("moe_group", [None, 32])
def test_prefill_logits_match_jax(qmoe, moe_group):
    """Prefill logits and K of (2, 96) tokens: three token groups of 64 at
    the config's moe_group, six of 32 under both frameworks'
    `ExecOptions.moe_group` override."""
    cfg, jm, jp, tm, tp = qmoe
    if moe_group:
        jm = jbuild(jcfg(ARCH).smoke(), JaxOpts(moe_group=moe_group))
        tm = build_model(cfg, transformer.ExecOptions(moe_group=moe_group),
                         device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (2, 96)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-4, rtol=1e-4)


def _prompts(cfg, lens=(9, 17, 40, 64)):
    """Prompts across the smoke engines' 16-row chunks; an exact-length
    prefill groups at most moe_group = 64 rows, so longer prompts are not
    whole groups (the reference asserts that too)."""
    rng = np.random.default_rng(8)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def test_chunked_engine_matches_greedy_and_jax(qmoe):
    """The paged chunked engine (page 8, chunk 16: prompts across chunk
    boundaries) emits `generate_greedy`'s tokens and the JAX engine's."""
    cfg, jm, jp, tm, tp = qmoe
    kw = dict(n_slots=2, max_len=128, page_size=8)
    te = ServeEngine(tm, params=tp, device="cpu", **kw)
    je = JaxEngine(jm, params=jp, prefix_cache=False, **kw)
    assert te.chunked and je.chunked
    prompts = _prompts(cfg)
    tr = [te.submit(p, max_new_tokens=5) for p in prompts]
    jr = [je.submit(p, max_new_tokens=5) for p in prompts]
    te.run_to_completion()
    je.run_to_completion()
    for p, a, b in zip(prompts, tr, jr):
        assert a.out_tokens == b.out_tokens, (len(p), a.out_tokens,
                                              b.out_tokens)
        assert a.out_tokens == generate_greedy(tm, tp, p, 5, max_len=128)
    for name in ("prefill_chunks", "decode_compiles", "chunk_compiles"):
        assert getattr(te.stats, name) == getattr(je.stats, name), name
    te.assert_accounting()
    assert te.stats.pages_in_use == 0


@pytest.mark.parametrize("paged,chunked", [(True, True), (True, False),
                                           (False, False)])
def test_int8_engine_matches_int8_oracle(qmoe, paged, chunked):
    """int8 weights (routed experts through the batched kernel's plain
    version) and int8 KV: every layout emits the dense int8 oracle's
    tokens."""
    cfg, _, _, tm, tp = qmoe
    kw = dict(paged=True, page_size=8, chunked_prefill=chunked) if paged \
        else dict(paged=False)
    te = ServeEngine(tm, params=tp, device="cpu", n_slots=2, max_len=128,
                     wdtype="int8", kv_dtype="int8", **kw)
    prompts = _prompts(cfg)
    reqs = [te.submit(p, max_new_tokens=4) for p in prompts]
    te.run_to_completion()
    for p, r in zip(prompts, reqs):
        assert r.out_tokens == generate_greedy(
            tm, tp, p, 4, max_len=128, wdtype="int8", kv_dtype="int8"), len(p)


def _served_alone(cfg, tp, plen=59, n=6):
    """One request served alone on a paged chunked engine (page 8, chunk
    16) that keeps logits, its router calls recorded."""
    eng = ServeEngine(build_model(cfg, device="cpu"), params=tp, device="cpu",
                      n_slots=2, max_len=128, page_size=8, keep_logits=True)
    prompt = _prompts(cfg, (plen,))[0]
    with recorded_routes() as rec:
        r = eng.submit(prompt, max_new_tokens=n)
        eng.run_to_completion()
    toks = _t(np.concatenate([prompt, np.asarray(r.out_tokens[:-1],
                                                 np.int32)]))
    return eng, prompt, r, toks, rec


def _replay_logits(tp, toks, cfg, segs, plen, forced=None):
    hidden, seen = teacher_forced_pass(tp, toks, cfg, segs, forced=forced)
    logits = transformer.lm_logits(tp, hidden[:, plen - 1:], cfg)[0]
    return logits[:, :cfg.vocab_size], seen


def test_teacher_forced_grouping_matches_engine(qmoe):
    """`moe_teacher_forced_segments` + `teacher_forced_pass` reproduce the
    chunked engine's logits for every decode step (prompt in chunk-sized
    groups from position 0, each generated token alone) at capacity_factor
    0.5, routed by the pass's own logits and by the engine's recorded
    choices (`engine_routes`), which are the pass's own here; one group over
    the whole 64-row sequence (capacity 8 for 128 assignments: many drops)
    lands far off."""
    cfg, _, _, _, tp = qmoe
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    eng, prompt, r, toks, rec = _served_alone(cfg, tp)
    plen, n = len(prompt), len(r.out_tokens)
    got = torch.stack(r.logits)[:, :cfg.vocab_size]
    segs = moe_teacher_forced_segments(plen, n, eng.chunk_tokens)
    assert segs == [(16, 16)] * 3 + [(10, 16), (6, 1)]
    idx, zs = engine_routes(rec, cfg.n_layers, plen, n, eng.chunk_tokens,
                            eng.n_slots)
    assert idx.shape == (cfg.n_layers, plen - 1 + n, cfg.moe_top_k)
    errs = []
    for s, forced in ((segs, None), (segs, idx), ([(len(toks), len(toks))],
                                                   None)):
        ref, seen = _replay_logits(tp, toks, cfg, s, plen, forced)
        errs.append((got - ref).abs().max().item())
        if s is segs:
            assert all(torch.equal(own, idx[i])
                       for i, (_, _, own) in enumerate(seen))
            assert max((z - zs[i]).abs().max().item()
                       for i, (_, z, _) in enumerate(seen)) <= 1e-4
    assert max(errs[:2]) <= 1e-4, errs
    assert errs[2] > 10 * max(errs[:2]), errs


def test_engine_replay_matches_engine(qmoe):
    """`engine_replay` gives the engine's logits at every step, routed by
    the engine's recorded choices or by its own: pass A keeps the prompt's
    last row in its chunk, pass C replays it as step 0's decode row."""
    cfg, _, _, _, tp = qmoe
    eng, prompt, r, toks, rec = _served_alone(cfg, tp, n=4)
    C, plen, n = eng.chunk_tokens, len(prompt), len(r.out_tokens)
    assert moe_teacher_forced_segments(plen, n, C, True) == [(16, 16)] * 3 \
        + [(11, 16), (3, 1)]
    got = torch.stack(r.logits)[:, :cfg.vocab_size]
    for routes in (rec, None):
        hidden, seen, eng_routes = engine_replay(
            tp, toks, cfg, plen, n, C, rec=routes, n_slots=eng.n_slots)
        ref = transformer.lm_logits(tp, hidden, cfg)[0, :, :cfg.vocab_size]
        assert (got - ref).abs().max().item() <= 1e-4
        assert all(z.shape[0] == plen + n for _, z, _ in seen)
        if routes is not None:
            assert all(torch.equal(own, eng_routes[0][i])
                       for i, (_, _, own) in enumerate(seen))


def test_teacher_forced_pass_routes_where_forced(qmoe):
    """Forcing the pass's own choices gives its unforced output bit for
    bit (`routed_gates` are `router_topk`'s gates); forcing other experts
    at one layer moves the output, and the pass still reports its own
    choices there."""
    cfg, _, _, _, tp = qmoe
    eng, prompt, r, toks, _ = _served_alone(cfg, tp, plen=40, n=4)
    segs = moe_teacher_forced_segments(len(prompt), len(r.out_tokens),
                                       eng.chunk_tokens)
    free, seen = _replay_logits(tp, toks, cfg, segs, len(prompt))
    own = torch.stack([o for _, _, o in seen])
    same, _ = _replay_logits(tp, toks, cfg, segs, len(prompt), forced=own)
    assert torch.equal(free, same)
    other = own.clone()
    other[1] = (other[1] + 1) % cfg.n_experts
    moved, seen2 = _replay_logits(tp, toks, cfg, segs, len(prompt),
                                  forced=other)
    assert (moved - free).abs().max().item() > 1e-3
    assert torch.equal(seen2[1][2], own[1])


def test_moe_training_raises(tmp_path):
    """The moe family trains: the call that `launch/train` refused before
    ROADMAP A14 now takes one finite step on the CPU, with the JAX loop's
    MoE groups; only a model-parallel mesh is still refused."""
    kw = dict(arch=ARCH, smoke=True, steps=1, global_batch=2, seq_len=16,
              device="cpu")
    losses, state = train_loop(ckpt_dir=str(tmp_path), **kw)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert int(state["opt"]["step"]) == 1
    assert state["params"]["layers"]["w1"].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="A14"):
        train_loop(ckpt_dir=str(tmp_path / "mp"), model_parallel=2, **kw)


def test_serve_cli_smoke_on_cpu(capsys):
    """`--arch qwen2-moe-a2.7b --smoke --device cpu` serves every request,
    int8 weights and KV included."""
    for extra in ([], ["--int8"]):
        stats = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                                "--requests", "3", "--slots", "2",
                                "--max-len", "64", "--new-tokens", "3",
                                "--page-size", "8"] + extra)
        assert stats.tokens_out == 9 and stats.pages_in_use == 0
    assert "3/3 done" in capsys.readouterr().out
