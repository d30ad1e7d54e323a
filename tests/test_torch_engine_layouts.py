"""Port parity, serving layouts: the port's `ServeEngine` in its dense
(`paged=False`), paged-monolithic (`chunked_prefill=False`) and
paged-chunked layouts against the JAX engine in the same layout, and within
the port against its own `generate_greedy` oracle (dense cache,
exact-length prefill), on smollm-360m `.smoke()` in f32 with JAX-initialised
weights; and the same cases (`*_configs`, the same bodies) on the dense
family's other configs with flags smollm-360m lacks: gemma-7b (GeGLU,
head_dim 64 at smoke size, scaled tied embeddings, (1+w) norms) and
chatglm3-6b (qkv bias, rope on half of each head) and qwen2.5-32b (qkv
bias, 5 query heads a KV head at full width, rope theta 1e6, untied
embeddings), whose prefill logits are also held to the JAX package's
(f32, atol = rtol = 1e-4).

The traffic is `bench_serve`'s mixed long/short wave (benchmarks/run.py:399):
a short request already decoding, then four long prompts (200-353 tokens:
buckets of 256 and 512, so monolithic prefill takes the blockwise attention
branch) among six short ones. Token streams and the deterministic counters
must equal the JAX engine's; within the port every layout must reproduce
the oracle exactly, in f32 and in int8 (weights and KV) against the dense
int8 oracle, as the reference promises (tests/test_chunked_prefill.py)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ExecOptions, build_model as jbuild
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.engine import generate_greedy as jax_greedy

from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine, generate_greedy

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

MAX_LEN, SLOTS, PAGE = 512, 4, 16
TOL = dict(atol=1e-4, rtol=1e-4)
# (paged, chunked_prefill): the three layouts of the reference
LAYOUTS = [(False, False), (True, False), (True, True)]
COUNTERS = ("prefills", "prefill_tokens", "prefill_pad_tokens",
            "prefill_chunks", "decode_steps", "tokens_out",
            "decode_stall_ticks", "peak_pages_in_use", "pages_in_use",
            "decode_compiles", "chunk_compiles")


# the dense family's configs beyond smollm-360m, as `*_configs` cases
CONFIGS = ["gemma-7b", "chatglm3-6b", "qwen2.5-32b"]


@pytest.fixture(scope="module")
def cases():
    """arch → (cfg, JAX model, JAX params, port model, bridged params),
    each built once a module."""
    built = {}

    def case(arch):
        if arch not in built:
            cfg = get_config(arch).smoke()
            jm = jbuild(cfg)               # default ExecOptions: chunked
            jp = jm.init(jax.random.key(0))
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
            built[arch] = (cfg, jm, jp, build_model(cfg, device="cpu"), tp)
        return built[arch]
    return case


@pytest.fixture(scope="module")
def smol(cases):
    return cases("smollm-360m")


def mixed_traffic(vocab):
    """[(prompt, max_new_tokens)]: bench_serve's wave. The first request is
    admitted and stepped once before the others are submitted."""
    rng = np.random.default_rng(7)
    out = [(rng.integers(0, vocab, 12).astype(np.int32), 24)]
    for i in range(10):
        n = 200 + 17 * i if i % 3 == 0 else 8 + 3 * i   # 4 long, 6 short
        out.append((rng.integers(0, vocab, n).astype(np.int32), 8))
    return out


def serve(eng, traffic):
    first = eng.submit(*traffic[0])
    eng.step()                          # a short request is already decoding
    reqs = [first] + [eng.submit(p, max_new_tokens=n) for p, n in traffic[1:]]
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return reqs


def _layout_kw(paged, chunked):
    if not paged:
        return dict(paged=False, chunked_prefill=chunked)
    return dict(paged=True, page_size=PAGE, chunked_prefill=chunked)


@pytest.fixture(scope="module")
def oracles(cases):
    """arch → the port's generate_greedy tokens of every request, f32 and
    int8, computed once a module."""
    done = {}

    def oracle(arch):
        if arch not in done:
            cfg, _, _, tm, tp = cases(arch)
            done[arch] = {
                quant: [generate_greedy(tm, tp, p, n, max_len=MAX_LEN,
                                        wdtype=quant, kv_dtype=quant)
                        for p, n in mixed_traffic(cfg.vocab_size)]
                for quant in (None, "int8")}
        return done[arch]
    return oracle


@pytest.fixture(scope="module")
def oracle(oracles):
    return oracles("smollm-360m")


def _layout_matches_jax_engine(case, oracle, paged, chunked):
    cfg, jm, jp, tm, tp = case
    kw = dict(n_slots=SLOTS, max_len=MAX_LEN, **_layout_kw(paged, chunked))
    if chunked and not paged:
        with pytest.raises(ValueError):
            JaxEngine(jm, params=jp, prefix_cache=False, **kw)
        with pytest.raises(ValueError):
            ServeEngine(tm, params=tp, device="cpu", **kw)
        return
    traffic = mixed_traffic(cfg.vocab_size)
    je = JaxEngine(jm, params=jp, prefix_cache=False, **kw)
    te = ServeEngine(tm, params=tp, device="cpu", **kw)
    assert (te.paged, te.chunked) == (je.paged, je.chunked) == (paged, chunked)
    jr, tr = serve(je, traffic), serve(te, traffic)
    for i, (a, b) in enumerate(zip(jr, tr)):
        assert b.out_tokens == a.out_tokens, (i, a.out_tokens, b.out_tokens)
        assert b.out_tokens == oracle[None][i], (i, b.out_tokens)
    for name in COUNTERS:
        assert getattr(te.stats, name) == getattr(je.stats, name), name
    assert te.stats.pages_in_use == 0
    assert te.stats.prefill_chunks == (0 if not chunked else
                                       je.stats.prefill_chunks)
    if paged:
        te.assert_accounting()
        assert te.pages_allocatable() == te.n_pages - 1
    assert te.kv_cache_bytes() == je.kv_cache_bytes()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
def test_layout_matches_jax_engine(smol, oracle, paged, chunked):
    """Each layout: tokens and counters equal the JAX engine's in the same
    layout, and the tokens equal the port's oracle. A dense engine cannot
    chunk: both frameworks refuse that combination."""
    _layout_matches_jax_engine(smol, oracle, paged, chunked)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("arch", CONFIGS)
def test_layout_matches_jax_engine_configs(cases, oracles, arch, paged,
                                           chunked):
    """`test_layout_matches_jax_engine` on the `CONFIGS`."""
    _layout_matches_jax_engine(cases(arch), oracles(arch), paged, chunked)


def _int8_layout_matches_dense_int8_oracle(case, oracle, paged, chunked):
    cfg, _, _, tm, tp = case
    te = ServeEngine(tm, params=tp, device="cpu", n_slots=SLOTS,
                     max_len=MAX_LEN, wdtype="int8", kv_dtype="int8",
                     **_layout_kw(paged, chunked))
    tr = serve(te, mixed_traffic(cfg.vocab_size))
    for i, r in enumerate(tr):
        assert r.out_tokens == oracle["int8"][i], (i, r.out_tokens)
    assert te.stats.pages_in_use == 0


@pytest.mark.parametrize("paged,chunked", LAYOUTS)
def test_int8_layout_matches_dense_int8_oracle(smol, oracle, paged, chunked):
    """int8 weights and KV: every layout reproduces the dense int8 oracle
    token for token (row quantization does not depend on the layout or the
    schedule)."""
    _int8_layout_matches_dense_int8_oracle(smol, oracle, paged, chunked)


@pytest.mark.parametrize("paged,chunked", LAYOUTS)
@pytest.mark.parametrize("arch", CONFIGS)
def test_int8_layout_matches_dense_int8_oracle_configs(cases, oracles, arch,
                                                       paged, chunked):
    """`test_int8_layout_matches_dense_int8_oracle` on the `CONFIGS`."""
    _int8_layout_matches_dense_int8_oracle(cases(arch), oracles(arch), paged,
                                           chunked)


def _generate_greedy_matches_jax(case, oracle):
    cfg, jm, jp, _, _ = case
    traffic = mixed_traffic(cfg.vocab_size)
    for i in (0, 1, 10):
        prompt, n = traffic[i]
        want = jax_greedy(jm, jp, prompt, n, max_len=MAX_LEN)
        assert oracle[None][i] == want, (i, oracle[None][i], want)


def test_generate_greedy_matches_jax(smol, oracle):
    """The port's oracle against JAX's on three prompts: short, the first
    long one (exact-length prefill of 200 rows, the reference branch) and
    the last (353 rows, the blockwise branch)."""
    _generate_greedy_matches_jax(smol, oracle)


@pytest.mark.parametrize("arch", CONFIGS)
def test_generate_greedy_matches_jax_configs(cases, oracles, arch):
    """`test_generate_greedy_matches_jax` on the `CONFIGS`."""
    _generate_greedy_matches_jax(cases(arch), oracles(arch))


@pytest.mark.parametrize("arch", ["smollm-360m"] + CONFIGS)
def test_prefill_logits_match_jax(cases, arch):
    """Prefill logits of two 12-token prompts (the reference attention on
    both sides) and the K/V rows they write equal the JAX package's at f32
    tolerance: qkv bias, half-head rope, GeGLU, (1+w) norms and scaled
    tied embeddings included."""
    import jax.numpy as jnp
    cfg, _, jp, tm, tp = cases(arch)
    jm = jbuild(cfg, ExecOptions(attn_impl="reference"))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)


def test_dense_engine_auto_layout(smol):
    """paged=None: paged when page_size divides max_len, else the largest
    page size that does (>= 8 rows), else dense — as the reference."""
    cfg, jm, jp, tm, tp = smol
    for max_len, page_size in ((64, 16), (72, 16), (36, 32)):
        kw = dict(n_slots=1, max_len=max_len, page_size=page_size)
        je = JaxEngine(jm, params=jp, prefix_cache=False, **kw)
        te = ServeEngine(tm, params=tp, device="cpu", **kw)
        assert (te.paged, te.chunked) == (je.paged, je.chunked)
        if te.paged:
            assert te.page_size == je.page_size
        assert te.kv_cache_bytes() == je.kv_cache_bytes()
