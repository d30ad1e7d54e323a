"""Port parity, model: `repro_torch.models.transformer` against
`repro.models.transformer` on smollm-360m `.smoke()` in f32 with the same
weights (JAX-initialised, bridged): prefill, decode (dense and paged) and
chunked prefill, comparing logits and the K/V rows they write.

Tolerance: f32 logits and rows `atol=rtol=1e-4` — the same math in another
summation order. Within the port, paged and dense decode run the same plain
attention on the same rows and must agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ExecOptions, build_model as jbuild

from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import alloc_cache

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def smol():
    cfg = get_config("smollm-360m").smoke()
    jm = jbuild(cfg, ExecOptions(attn_impl="reference"))
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, jp, build_model(cfg, device="cpu"), tp


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_prefill_logits_and_rows(smol):
    cfg, jm, jp, tm, tp = smol
    toks = _tokens(0, (2, 12))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)
    assert tc["pos"].tolist() == [12, 12]


def _paged_from_dense(rows, page_size, pps, perm):
    """(L, B, S, KV, D) rows → (L, n_pages, ps, KV, D) pool + table."""
    L, b, s = rows.shape[:3]
    n_pages = 1 + b * pps
    pool = np.zeros((L, n_pages, page_size) + rows.shape[3:], rows.dtype)
    table = (perm[:b * pps] + 1).reshape(b, pps).astype(np.int32)
    for bi in range(b):
        for j in range(pps):
            lo = j * page_size
            n = max(0, min(page_size, s - lo))
            pool[:, table[bi, j], :n] = rows[:, bi, lo:lo + n]
    return pool, table


def test_decode_dense_and_paged(smol):
    cfg, jm, jp, tm, tp = smol
    b, plen, smax, ps = 2, 10, 32, 8
    toks = _tokens(1, (b, plen))
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    rows = {k: np.asarray(jc[k]) for k in ("k", "v")}
    dense = {k: np.zeros(v.shape[:2] + (smax,) + v.shape[3:], np.float32)
             for k, v in rows.items()}
    for k in dense:
        dense[k][:, :, :plen] = rows[k]
    perm = np.random.default_rng(2).permutation(b * smax // ps)
    paged = {}
    for k in rows:
        paged[k], table = _paged_from_dense(dense[k], ps, smax // ps, perm)
    pos = np.full((b,), plen, np.int32)
    jd = dict({k: jnp.asarray(v) for k, v in dense.items()}, pos=jnp.asarray(pos))
    jpg = dict({k: jnp.asarray(v) for k, v in paged.items()},
               pos=jnp.asarray(pos), page_table=jnp.asarray(table))
    td = dict({k: _t(v) for k, v in dense.items()}, pos=_t(pos))
    tpg = dict({k: _t(v) for k, v in paged.items()}, pos=_t(pos),
               page_table=_t(table))
    for step in range(3):
        tok = _tokens(10 + step, (b, 1))
        jl, jd = jm.decode(jp, {"tokens": jnp.asarray(tok)}, jd)
        jlp, jpg = jm.decode(jp, {"tokens": jnp.asarray(tok)}, jpg)
        tl, td = tm.decode(tp, {"tokens": _t(tok)}, td)
        tlp, tpg = tm.decode(tp, {"tokens": _t(tok)}, tpg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **TOL)
        np.testing.assert_array_equal(tlp.numpy(), tl.numpy())
    assert td["pos"].tolist() == [plen + 3] * b
    for k in ("k", "v"):
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), **TOL)
        np.testing.assert_allclose(tpg[k].numpy(), np.asarray(jpg[k]), **TOL)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_prefill_chunk_pools_then_decode(smol, kv_dtype):
    """Two chunks (the second ragged) stream a 13-token prompt into the page
    pool through a shuffled page row; then the replay decode step. f32 pools
    agree to TOL; int8 pools hold the same bytes up to rare one-step
    rounding flips of values that sit on a rounding edge."""
    cfg, jm, jp, tm, tp = smol
    max_len, ps, C, plen = 32, 4, 8, 13
    jdt = {"f32": jnp.float32, "int8": jnp.int8}[kv_dtype]
    tdt = {"f32": torch.float32, "int8": torch.int8}[kv_dtype]
    n_pages = 1 + max_len // ps
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_shape(1, max_len, jdt, page_size=ps,
                                         n_pages=n_pages))
    tcache = alloc_cache(tm.cache_shape(1, max_len, tdt, page_size=ps,
                                        n_pages=n_pages), "cpu")
    row = np.zeros((max_len // ps,), np.int32)
    row[:4] = [5, 2, 7, 3]                      # 4 pages cover 13 rows + 3
    prompt = _tokens(3, (plen,))
    for start in range(0, plen, C):
        n = min(C, plen - start)
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = prompt[start:start + n]
        batch = dict(tokens=toks, start=np.asarray([start], np.int32),
                     length=np.asarray([n], np.int32), page_row=row)
        jcache = jm.prefill_chunk(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                                  jcache)
        tcache = tm.prefill_chunk(tp, {k: _t(v) for k, v in batch.items()},
                                  tcache)
    for key in ("k", "v"):
        want, got = np.asarray(jcache[key]), tcache[key].numpy()
        if kv_dtype == "f32":
            np.testing.assert_allclose(got, want, **TOL)
        else:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() > 0.99
            np.testing.assert_allclose(tcache[key + "s"].numpy().astype(np.float32),
                                       np.asarray(jcache[key + "s"]).astype(np.float32),
                                       rtol=1e-3)
    # finalize (stamp the row and the replay position), then one decode step
    jcache = dict(jcache, page_table=jnp.asarray(row[None]),
                  pos=jnp.asarray([plen - 1], jnp.int32))
    tcache["page_table"][0] = _t(row)
    tcache["pos"][0] = plen - 1
    tok = prompt[-1:][None]
    jl, _ = jm.decode(jp, {"tokens": jnp.asarray(tok)}, jcache)
    tl, _ = tm.decode(tp, {"tokens": _t(tok)}, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               **(TOL if kv_dtype == "f32" else
                                  dict(atol=1e-2, rtol=1e-2)))


def test_entry_points_default_to_cuda():
    """device=None means CUDA: without a GPU it raises, never falls back."""
    cfg = get_config("smollm-360m").smoke()
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_training_recurrent_families_raises(arch, tmp_path):
    """The ssm and hybrid families train: the call that `launch/train`
    refused before ROADMAP A14 now takes one finite step on the CPU and
    checkpoints it; only a model-parallel mesh is still refused."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.checkpoint import CheckpointManager
    kw = dict(arch=arch, smoke=True, steps=1, global_batch=2, seq_len=16,
              device="cpu")
    losses, state = train_loop(ckpt_dir=str(tmp_path), **kw)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert int(state["opt"]["step"]) == 1
    assert CheckpointManager(str(tmp_path)).latest_step() == 0
    with pytest.raises(NotImplementedError, match="A14"):
        train_loop(ckpt_dir=str(tmp_path / "mp"), model_parallel=2, **kw)


def test_model_init_seeded(smol):
    cfg, _, _, tm, _ = smol
    a, b = tm.init(3), tm.init(3)
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], tm.init(4)["layers"]["wq"])
    assert a["embed"].dtype == torch.float32       # smoke config dtype
