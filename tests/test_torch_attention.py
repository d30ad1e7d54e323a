"""Port parity, attention: the port's decode and chunk-prefill attention
dispatchers (their plain PyTorch path on CPU tensors) against the JAX
package's reference branch and its Pallas kernels in interpret mode, on
numpy inputs from a seed.

Tolerance: f32 `atol=2e-5` — the same online/two-pass softmax in another
summation order, the bar the JAX package holds its own kernels to
(tests/test_decode_attention_kernel.py). Chunk attention compares rows
`< length` only: padding rows are garbage by contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention_paged
from repro.models import attention as jattn
from repro.models.quantized import quantize_kv_rows as jquant

from repro_torch.models import attention as tattn

TOL = 2e-5


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x, copy=True))


def _inputs(seed, b, kv, g, d, ps, pps, *, int8=False, sq=1):
    """Page pools with a shuffled table (page 0 = null page) and the same
    rows as a dense per-sequence cache."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * pps
    q = rng.standard_normal((b, sq, kv, g, d)).astype(np.float32)
    pk = rng.standard_normal((n_pages, ps, kv, d)).astype(np.float32)
    pv = rng.standard_normal((n_pages, ps, kv, d)).astype(np.float32)
    pt = (rng.permutation(n_pages - 1) + 1).reshape(b, pps).astype(np.int32)
    ks = vs = None
    if int8:
        (pk, ks), (pv, vs) = (tuple(np.asarray(a) for a in jquant(jnp.asarray(p)))
                              for p in (pk, pv))
    return q, pk, pv, ks, vs, pt


def _dense(pool, pt):
    b = pt.shape[0]
    return None if pool is None else pool[pt].reshape(b, -1, *pool.shape[2:])


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_four_variants(paged, int8):
    b, kv, g, d, ps, pps = 3, 2, 3, 32, 8, 4
    q, pk, pv, ks, vs, pt = _inputs(11 + 2 * paged + int8, b, kv, g, d, ps,
                                    pps, int8=int8)
    kv_len = np.asarray([5, 32, 17], np.int32)
    if paged:
        caches, table = (pk, pv, ks, vs), pt
    else:
        caches, table = tuple(_dense(c, pt) for c in (pk, pv, ks, vs)), None
    kc, vc, kss, vss = caches
    jkw = dict(page_table=None if table is None else jnp.asarray(table),
               k_scale=None if kss is None else jnp.asarray(kss),
               v_scale=None if vss is None else jnp.asarray(vss))
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kv_len), impl="reference", **jkw))
    pal = np.asarray(pallas_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kv_len), block_k=8, interpret=True, **jkw))
    got = tattn.decode_attention(
        _t(q), _t(kc), _t(vc), _t(kv_len), page_table=_t(table),
        k_scale=_t(kss), v_scale=_t(vss)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, pal, atol=TOL)


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_kv_len_zero_and_window(window):
    b, kv, g, d, ps, pps = 2, 1, 2, 32, 8, 2
    q, pk, pv, _, _, pt = _inputs(21, b, kv, g, d, ps, pps)
    kv_len = np.asarray([0, 13], np.int32)
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(kv_len),
        window=window, page_table=jnp.asarray(pt), impl="reference"))
    got = tattn.decode_attention(_t(q), _t(pk), _t(pv), _t(kv_len),
                                 window=window, page_table=_t(pt)).numpy()
    assert np.all(got[0] == 0.0)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [0, 10])
def test_chunk_attention_paged_matches_jax(int8, window):
    """One chunk at a mid-prompt offset, rows past `length` are padding."""
    b, kv, g, d, ps, pps, C = 1, 2, 2, 32, 8, 4, 8
    q, pk, pv, ks, vs, pt = _inputs(31 + int8, b, kv, g, d, ps, pps,
                                    int8=int8, sq=C)
    start, length = 16, 5
    q_off = np.asarray([start], np.int32)
    kv_len = np.asarray([start + length], np.int32)
    jkw = dict(window=window,
               k_scale=None if ks is None else jnp.asarray(ks),
               v_scale=None if vs is None else jnp.asarray(vs))
    want = np.asarray(jattn.chunk_attention_paged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pt),
        jnp.asarray(q_off), kv_len=jnp.asarray(kv_len), impl="reference",
        **jkw))
    pal = np.asarray(flash_attention_paged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pt),
        jnp.asarray(q_off), jnp.asarray(kv_len), interpret=True, **jkw))
    got = tattn.chunk_attention_paged(
        _t(q), _t(pk), _t(pv), _t(pt), _t(q_off), kv_len=_t(kv_len),
        window=window, k_scale=_t(ks), v_scale=_t(vs)).numpy()
    np.testing.assert_allclose(got[:, :length], want[:, :length], atol=TOL)
    np.testing.assert_allclose(got[:, :length], pal[:, :length], atol=TOL)


def test_chunk_attention_no_live_rows_gives_zeros():
    """kv_len == 0: every row has no valid key → zeros, as the kernels."""
    q, pk, pv, _, _, pt = _inputs(41, 1, 1, 2, 32, 8, 2, sq=4)
    got = tattn.chunk_attention_paged(
        _t(q), _t(pk), _t(pv), _t(pt), torch.zeros(1, dtype=torch.int32),
        kv_len=torch.zeros(1, dtype=torch.int32)).numpy()
    assert np.all(got == 0.0)


def test_reference_attention_matches_jax():
    rng = np.random.default_rng(51)
    q = rng.standard_normal((2, 9, 2, 3, 32)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 32)).astype(np.float32)
    for window in (0, 4):
        want = np.asarray(jattn.reference_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window))
        got = tattn.attention(_t(q), _t(k), _t(v), window=window).numpy()
        np.testing.assert_allclose(got, want, atol=TOL)


def test_unported_cache_kinds_raise():
    q, pk, pv, _, _, pt = _inputs(61, 1, 1, 1, 32, 8, 1)
    with pytest.raises(NotImplementedError, match="A10"):
        tattn.decode_attention(_t(q), _t(pk), _t(pv), torch.ones(1),
                               page_table=_t(pt), v_dim=16)
    with pytest.raises(NotImplementedError, match="A9"):
        tattn.decode_attention(_t(q), _t(pk).to(torch.float8_e5m2),
                               _t(pv).to(torch.float8_e5m2), torch.ones(1),
                               page_table=_t(pt))
