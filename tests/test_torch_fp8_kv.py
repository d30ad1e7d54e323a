"""Port parity, fp8 (e5m2) KV caches: the port's dense fp8 engine and the
attention paths that read fp8 rows, against the JAX package on smollm-360m
`.smoke()` (f32, JAX-initialised weights bridged to torch), plus the five
cases of the reference's `tests/test_fp8_kv.py` on the port.

fp8 is a bare cast round trip through `float8_e5m2`, no scale tensors, in
the dense layout only (a paged fp8 engine raises ValueError, as the
reference's does). The casts must round as `ml_dtypes` does, overflow to
inf included, so the bits are held against `jnp.astype(float8_e5m2)`.

Tolerance: f32 `atol=rtol=1e-4` for attention outputs and logits; bits and
token streams exactly, except that a stream held to the JAX engine's may
part at a near-tie (top-1 margin below `MARGIN` in the port's logits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ExecOptions, build_model as jbuild
from repro.models import attention as jattn
from repro.models.transformer import _round_rows as jround_rows
from repro.models.transformer import cache_shape as jcache_shape
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import _round_rows
from repro_torch.serve.engine import ServeEngine, generate_greedy

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3
E5M2 = torch.float8_e5m2


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x, copy=True))


def _prompt(seed, n, vocab=512):
    return np.asarray(
        jax.random.randint(jax.random.key(seed), (n,), 0, vocab), np.int32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


def _jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


@pytest.fixture(scope="module")
def smol():
    cfg = get_config("smollm-360m").smoke()
    jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=32))
    jp = jm.init(jax.random.key(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, jp, build_model(cfg, device="cpu"), tp


def _edge_values():
    """Random magnitudes over 1e-8 .. 1e6 and the e5m2 edges: the largest
    finite value 57344, the midpoint 61440 (rounds to inf), subnormals,
    signed zeros and infinities."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(20000) * 10.0 ** rng.uniform(-8, 6, 20000)
    edges = [57344, 57343.9, 61439, 61440, 61441, 65536, 1e6, -1e6, np.inf,
             -np.inf, 0.0, -0.0, 2 ** -16, 2 ** -17, 1.5 * 2 ** -16, 1e-8,
             -1e-8, 2 ** -14, 3 * 2 ** -17]
    return np.concatenate([x, edges]).astype(np.float32)


@pytest.mark.parametrize("src", ["f32", "bf16"])
def test_e5m2_cast_bits_match_jax(src):
    """`.to(float8_e5m2)` equals `jnp.astype(float8_e5m2)` bit for bit from
    f32 and from bf16 (nearest even, overflow past 61440 to inf,
    subnormals); NaN stays NaN (the two NaN payloads differ)."""
    x = _edge_values()
    t, j = torch.from_numpy(x), jnp.asarray(x)
    if src == "bf16":
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    np.testing.assert_array_equal(_bits(t.to(E5M2)),
                                  _jbits(j.astype(jnp.float8_e5m2)))
    assert torch.isinf(torch.tensor([61440.0, -1e6]).to(E5M2).float()).all()
    assert torch.isnan(torch.tensor([float("nan")]).to(E5M2).float()).all()


def test_round_rows_e5m2_is_cast_roundtrip():
    """`_round_rows` with fp8 storage is the cast round trip, no scales,
    bit-equal to JAX's, and it loses mantissa bits."""
    rows = np.asarray(jax.random.normal(jax.random.key(0), (2, 5, 2, 8),
                                        jnp.float32) * 7.0)
    want = np.asarray(jround_rows(jnp.asarray(rows), jnp.float8_e5m2))
    got = _round_rows(_t(rows), E5M2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), _t(rows).to(E5M2).float().numpy())
    assert not np.array_equal(got.numpy(), rows), \
        "e5m2 round trip should actually lose mantissa bits"


def test_cache_shape_fp8_has_no_scale_tensors(smol):
    """The dense fp8 cache is the bf16 layout at one byte an element: the
    same keys (no 'ks'/'vs'), the same shapes, JAX's shapes."""
    cfg, jm, _, tm, _ = smol
    fp8 = tm.cache_shape(2, 32, E5M2)
    bf16 = tm.cache_shape(2, 32, torch.bfloat16)
    assert set(fp8) == set(bf16)
    assert not any(k.endswith("s") and k != "pos" for k in fp8), fp8.keys()
    assert fp8["k"][0] == bf16["k"][0] and fp8["k"][1] == E5M2
    want = jcache_shape(cfg, 2, 32, jnp.float8_e5m2)
    assert {k: tuple(v.shape) for k, v in want.items()} == \
        {k: tuple(v[0]) for k, v in fp8.items()}


def _fp8_inputs(seed, b, kv, g, d, smax, *, sq=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, smax, kv, d)).astype(np.float32) * 3
    v = rng.standard_normal((b, smax, kv, d)).astype(np.float32) * 3
    jk, jv = (jnp.asarray(a).astype(jnp.float8_e5m2) for a in (k, v))
    tk, tv = (_t(a).to(E5M2) for a in (k, v))
    return q, (jk, jv), (tk, tv)


@pytest.mark.parametrize("window", [0, 5])
def test_fp8_decode_attention_matches_jax(window):
    """Decode attention on a dense e5m2 cache: the port's plain path (the
    CPU's; the card's decode kernel upcasts e5m2 in its load) against
    JAX's jnp path, which upcasts the view once."""
    b, kv, g, d, smax = 3, 2, 3, 32, 24
    q, (jk, jv), (tk, tv) = _fp8_inputs(3, b, kv, g, d, smax)
    lens = np.asarray([1, 13, 24], np.int32)
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(lens), window=window,
        impl="reference"))
    got = tattn.decode_attention(_t(q), tk, tv, _t(lens), window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fp8_chunk_attention_matches_jax():
    """Chunk attention over an e5m2 pool through a page table: the port's
    plain path against JAX's jnp path (rows below the chunk's length)."""
    b, kv, g, d, ps, pps, c = 1, 2, 2, 32, 8, 4, 8
    rng = np.random.default_rng(9)
    n_pages = 1 + pps
    q = rng.standard_normal((b, c, kv, g, d)).astype(np.float32)
    pools = [rng.standard_normal((n_pages, ps, kv, d)).astype(np.float32) * 3
             for _ in "kv"]
    table = (rng.permutation(pps) + 1).reshape(1, pps).astype(np.int32)
    start, n = 11, 6
    kw = dict(kv_len=np.asarray([start + n], np.int32))
    want = np.asarray(jattn.chunk_attention_paged(
        jnp.asarray(q), *(jnp.asarray(p).astype(jnp.float8_e5m2)
                          for p in pools),
        jnp.asarray(table), jnp.asarray([start], jnp.int32),
        kv_len=jnp.asarray(kw["kv_len"]), impl="reference"))
    got = tattn.chunk_attention_paged(
        _t(q), *(_t(p).to(E5M2) for p in pools), _t(table),
        torch.tensor([start], dtype=torch.int32), kv_len=_t(kw["kv_len"]))
    np.testing.assert_allclose(got.numpy()[:, :n], want[:, :n], **TOL)


@pytest.mark.parametrize("kv_dtype", ["fp8", "e5m2"])
def test_fp8_dense_engine_token_exact(smol, kv_dtype):
    """Dense fp8 engine == the fp8 `generate_greedy` oracle, token for
    token ('fp8' and 'e5m2' name the same storage)."""
    _, _, _, tm, tp = smol
    for n in (9, 17):
        solo = generate_greedy(tm, tp, _prompt(n, n), n_tokens=4,
                               max_len=64, kv_dtype=kv_dtype)
        eng = ServeEngine(tm, n_slots=2, max_len=64, params=tp, paged=False,
                          kv_dtype=kv_dtype, device="cpu")
        assert eng._cache["k"].dtype == E5M2
        r = eng.submit(_prompt(n, n), max_new_tokens=4)
        eng.run_to_completion()
        assert r.out_tokens == solo, (kv_dtype, n, r.out_tokens, solo)


def test_fp8_actually_rounds(smol):
    """The fp8 stream diverges from the f32 stream over 8 tokens: the cast
    round trip is no no-op."""
    _, _, _, tm, tp = smol
    p = _prompt(5, 13)
    f32 = generate_greedy(tm, tp, p, n_tokens=8, max_len=64)
    fp8 = generate_greedy(tm, tp, p, n_tokens=8, max_len=64, kv_dtype="fp8")
    assert fp8 != f32, "e5m2 KV produced the f32 token stream bit-for-bit"


@pytest.mark.parametrize("paged", [None, True])
def test_fp8_paged_pool_refused(smol, paged):
    """A paged fp8 engine (explicit, or the default layout) raises
    ValueError, as the reference's does; no silent dense or bf16 layout."""
    _, _, _, tm, tp = smol
    with pytest.raises(ValueError, match="fp8|e5m2"):
        ServeEngine(tm, n_slots=2, max_len=64, params=tp, page_size=8,
                    paged=paged, kv_dtype="fp8", device="cpu")


def test_fp8_engine_matches_jax_engine(smol):
    """Two slots, three prompts (one longer than the others' bucket): the
    port's dense fp8 engine emits the JAX engine's tokens, and its cache
    rows are the JAX cache's bits where both wrote them."""
    cfg, jm, jp, tm, tp = smol
    kw = dict(n_slots=2, max_len=64, paged=False, kv_dtype="fp8")
    prompts = [_prompt(n, n) for n in (9, 17, 30)]
    jeng = JaxEngine(jm, params=jp, **kw)
    jreqs = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    jeng.run_to_completion()
    eng = ServeEngine(tm, params=tp, device="cpu", keep_logits=True, **kw)
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run_to_completion()
    for r, jr in zip(reqs, jreqs):
        t = next((t for t, (a, b) in enumerate(zip(r.out_tokens,
                                                    jr.out_tokens))
                  if a != b), None)
        if t is not None:
            top2 = torch.topk(r.logits[t], 2).values
            assert (top2[0] - top2[1]).item() < MARGIN, (r.rid, t)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]


def test_fp8_mla_dense_engine():
    """An MLA model (deepseek-v2-lite smoke) on a dense fp8 latent cache:
    one e5m2 pool "k", engine == the fp8 oracle."""
    from repro.configs import get_config as jcfg
    from repro_torch.configs import get_config as tcfg
    jm = jbuild(jcfg("deepseek-v2-lite").smoke(),
                ExecOptions(attn_impl="reference", ce_chunk=32))
    tp = params_from_numpy(jax.tree.map(np.asarray,
                                        jm.init(jax.random.key(1))), "cpu")
    tm = build_model(tcfg("deepseek-v2-lite").smoke(), device="cpu")
    p = _prompt(17, 17)
    solo = generate_greedy(tm, tp, p, n_tokens=4, max_len=64, kv_dtype="fp8")
    eng = ServeEngine(tm, n_slots=2, max_len=64, params=tp, paged=False,
                      kv_dtype="fp8", device="cpu")
    assert sorted(eng._cache) == ["k", "pos"]
    assert eng._cache["k"].dtype == E5M2
    r = eng.submit(p, max_new_tokens=4)
    eng.run_to_completion()
    assert r.out_tokens == solo


def test_serve_cli_fp8():
    """`--kv-dtype fp8 --page-size 0` serves; with pages it is refused, as
    the reference's CLI refuses it."""
    stats = serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3",
                            "--slots", "2", "--max-len", "64",
                            "--new-tokens", "3", "--page-size", "0",
                            "--kv-dtype", "fp8"])
    assert stats.tokens_out == 9
    with pytest.raises(SystemExit):
        serve_cli.main(["--smoke", "--device", "cpu", "--kv-dtype", "fp8"])
