"""Port parity, training: the port's data pipeline, optimizer, gradient
compression, train mode and loss, and train step against the JAX package,
on smollm-360m `.smoke()` (float32) with JAX-initialised weights bridged to
torch and inputs made with numpy from a seed. JAX's Pallas block quantizers
run in interpret mode on the CPU; the port's take their plain versions
there. Checkpoints, train_loop and elastic: tests/test_torch_train_loop.py.

Tolerances (f32 on both sides, the same math in another summation order):
data and quantizer outputs bit-identical; `lr_at` 1e-7 relative; one AdamW
update 1e-6 relative; the loss 1e-5 and its gradients atol 1e-5 / rtol 1e-4;
one full train step 1e-5 relative (exceptions stated where they apply)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data import pipeline as jdata
from repro.launch import steps as jsteps
from repro.models import ExecOptions, build_model as jbuild
from repro.train import compression as jcomp
from repro.train import optimizer as jopt

from repro_torch.bridge import params_from_numpy
from repro_torch.data import pipeline as tdata
from repro_torch.launch import steps as tsteps
from repro_torch.models.registry import build_model
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.tree import tree_paths

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

SEQ, BATCH = 32, 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _same_bytes(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _assert_tree_close(got, want, **tol):
    """got: torch tree; want: numpy/JAX tree with the same keys."""
    want = tree_paths(_np_tree(want))
    got = tree_paths(got)
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].detach().numpy(), w, err_msg=key,
                                   **tol)


def _batch(step=0, vocab=512):
    cfg = jdata.DataConfig(vocab_size=vocab, seq_len=SEQ, global_batch=BATCH)
    return jdata.TokenSource(cfg).batch_at(step)


@pytest.fixture(scope="module")
def smol():
    """JAX-initialised smoke params with the attention projections scaled
    to their contraction fan-in. The schema init takes the head count as
    the q/k/v fan-in (ROADMAP C): its softmax is near one-hot and the
    backward pass amplifies f32 rounding to ~1e-4 of the embedding gradient
    in either framework. Rescaled, both agree to ~4e-7; the train_loop
    tests (test_torch_train_loop.py) run from the schema init itself."""
    cfg = get_config("smollm-360m").smoke()
    p = _np_tree(jbuild(cfg, ExecOptions(attn_impl="reference")).init(
        jax.random.key(0)))
    gain = {"wq": cfg.n_heads / cfg.d_model,
            "wk": cfg.n_kv_heads / cfg.d_model,
            "wv": cfg.n_kv_heads / cfg.d_model,
            "wo": 1 / cfg.n_heads}
    p["layers"] = {k: v * np.float32(gain[k] ** 0.5) if k in gain else v
                   for k, v in p["layers"].items()}
    return cfg, p


# --------------------------------------------------------------- (a) data
def test_token_source_bit_equal(tmp_path):
    toks = np.random.default_rng(0).integers(0, 50000, 9000).astype(np.uint16)
    path = tmp_path / "toks.bin"
    toks.tofile(path)
    for kw in ({}, {"path": str(path)}, {"n_hosts": 2, "host_id": 1}):
        jsrc = jdata.TokenSource(jdata.DataConfig(49152, SEQ, BATCH, **kw))
        tsrc = tdata.TokenSource(tdata.DataConfig(49152, SEQ, BATCH, **kw))
        for step in range(4):
            jb, tb = jsrc.batch_at(step), tsrc.batch_at(step)
            assert set(jb) == set(tb) == {"tokens", "labels"}
            for k in jb:
                assert _same_bytes(tb[k], jb[k]), (kw, step, k)


def test_prefetch_iterator_replays_the_stream():
    src = tdata.TokenSource(tdata.DataConfig(512, SEQ, BATCH, seed=3))
    it = tdata.PrefetchIterator(src, start_step=2)
    try:
        got = [next(it) for _ in range(3)]
    finally:
        it.close()
    jsrc = jdata.TokenSource(jdata.DataConfig(512, SEQ, BATCH, seed=3))
    assert [s for s, _ in got] == [2, 3, 4]
    for s, b in got:
        assert _same_bytes(b["tokens"], jsrc.batch_at(s)["tokens"])


# ---------------------------------------------------------- (b) optimizer
def test_lr_schedule_matches_jax():
    cfg = dict(peak_lr=3e-4, warmup_steps=20, total_steps=40)
    steps = np.arange(41, dtype=np.int32)
    want = np.asarray(jopt.lr_at(jopt.OptimizerConfig(**cfg),
                                 jnp.asarray(steps)))
    got = topt.lr_at(topt.OptimizerConfig(**cfg), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)


def test_adamw_and_clip_match_jax(smol):
    cfg, p = smol
    rng = np.random.default_rng(1)
    grads = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32), p)
    ocfg = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jstate = jopt.init_opt_state(jax.tree.map(jnp.asarray, p))
    jg, jnorm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    jp, jo, jlr = jopt.adamw_update(jax.tree.map(jnp.asarray, p), jg, jstate,
                                    jopt.OptimizerConfig(**ocfg))
    tp = params_from_numpy(p)
    tg, tnorm = topt.clip_by_global_norm(params_from_numpy(grads), 1.0)
    tp, to, tlr = topt.adamw_update(tp, tg, topt.init_opt_state(tp),
                                    topt.OptimizerConfig(**ocfg))
    tol = dict(rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(tnorm), float(jnorm), **tol)
    np.testing.assert_allclose(float(tlr), float(jlr), **tol)
    _assert_tree_close(tg, jg, **tol)
    # p − lr·delta cancels to ~0 for some small params; there the two
    # roundings differ by a fraction of the operands' ulp (~2e-9)
    _assert_tree_close(tp, jp, rtol=1e-6, atol=1e-9)
    _assert_tree_close(to["m"], jo["m"], **tol)
    _assert_tree_close(to["v"], jo["v"], **tol)
    assert int(to["step"]) == int(jo["step"]) == 1
    assert to["step"].dtype == torch.int32


# -------------------------------------------------------- (c) compression
def test_compress_decompress_bit_identical(smol):
    _, p = smol
    rng = np.random.default_rng(2)
    grads = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape)
                   * np.exp(rng.uniform(-8, 0))).astype(np.float32), p)
    err = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 1e-4).astype(np.float32), p)
    for state in (None, err):
        jg, je = jcomp.compress_decompress(
            jax.tree.map(jnp.asarray, grads),
            None if state is None else jax.tree.map(jnp.asarray, state))
        tg, te = tcomp.compress_decompress(
            params_from_numpy(grads),
            None if state is None else params_from_numpy(state))
        for got, want in ((tg, jg), (te, je)):
            want, got = tree_paths(_np_tree(want)), tree_paths(got)
            assert set(got) == set(want)
            for k in want:
                assert _same_bytes(got[k].numpy(), want[k]), k
    for shape in ((1,), (1000,), (1024, 1024), (3, 5, 7)):
        assert tcomp.payload_ratio(shape) == jcomp.payload_ratio(shape)


def test_error_feedback_accumulates_as_the_reference():
    """As tests/test_compression.py: with error feedback the sent signal
    plus the residual equals the true accumulated gradient."""
    rng = np.random.default_rng(3)
    err = tcomp.init_error_state({"g": torch.zeros(512)})
    total_true = torch.zeros(512)
    total_sent = torch.zeros(512)
    jerr = {"g": jnp.zeros((512,), jnp.float32)}
    for _ in range(20):
        g = (rng.standard_normal(512) * 0.1).astype(np.float32)
        ghat, err = tcomp.compress_decompress({"g": torch.from_numpy(g)}, err)
        jghat, jerr = jcomp.compress_decompress({"g": jnp.asarray(g)}, jerr)
        assert _same_bytes(ghat["g"].numpy(), np.asarray(jghat["g"]))
        assert _same_bytes(err["g"].numpy(), np.asarray(jerr["g"]))
        total_true += torch.from_numpy(g)
        total_sent += ghat["g"]
    assert (total_sent + err["g"] - total_true).abs().max().item() < 1e-4


def test_compressed_ring_allreduce_waits_for_a12():
    with pytest.raises(NotImplementedError, match="A12"):
        tcomp.compressed_ring_allreduce(torch.zeros(4), "data")


# ------------------------------------------------------ (d) loss and grads
@pytest.mark.parametrize("remat", ["full", "none"])
def test_train_loss_and_grads_match_jax(smol, remat):
    cfg, p = smol
    batch = _batch(0)
    jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=16,
                                 remat=remat))
    (jloss, _), jgrads = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, p),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tm = build_model(cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, tgrads = tsteps.loss_and_grads(tm, params_from_numpy(p), tb,
                                          ce_chunk=16, remat=remat)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=0, atol=1e-5)
    _assert_tree_close(tgrads, jgrads, atol=1e-5, rtol=1e-4)


def test_ce_ignores_unlabelled_positions(smol):
    cfg, p = smol
    batch = _batch(1)
    batch["labels"][:, ::3] = -1
    jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=8))
    jloss, _ = jm.train_loss(jax.tree.map(jnp.asarray, p),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    tm = build_model(cfg, device="cpu")
    tloss, _ = tm.train_loss(params_from_numpy(p),
                             {k: torch.from_numpy(v) for k, v in batch.items()},
                             ce_chunk=8)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=0, atol=1e-5)


# ---------------------------------------------------------- (e) train step
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax(smol, compress, n_micro):
    cfg, p = smol
    batch = _batch(2)
    # eps 1e-3: at step 1 AdamW moves each param by lr·g/(|g|+eps); with
    # eps 1e-8 a gradient within rounding of zero (a few of 65k embedding
    # entries) steps by an arbitrary fraction of lr in either framework
    ocfg = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)
    jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=SEQ,
                                 remat="full"))
    jgt = (lambda g: jcomp.compress_decompress(g)[0]) if compress else None
    jstep = jax.jit(jsteps.make_train_step(jm, jopt.OptimizerConfig(**ocfg),
                                           jgt, n_micro=n_micro))
    jparams = jax.tree.map(jnp.asarray, p)
    jstate = {"params": jparams, "opt": jopt.init_opt_state(jparams)}
    jnew, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    tm = build_model(cfg, device="cpu")
    tgt = (lambda g: tcomp.compress_decompress(g)[0]) if compress else None
    tstep = tsteps.make_train_step(tm, topt.OptimizerConfig(**ocfg), tgt,
                                   n_micro=n_micro, ce_chunk=SEQ, remat="full")
    tstate = params_from_numpy(_np_tree(jstate))
    tnew, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   atol=0, err_msg=k)
    # each param moves by lr·g/(|g|+eps) (+ decay): held to 1e-5 relative,
    # or to 1 % of lr where that step differs by rounding of a small g
    lr = ocfg["peak_lr"]
    checks = [("params", tnew["params"], jnew["params"], 1e-2 * lr,
               lambda w: 2 * lr),
              ("m", tnew["opt"]["m"], jnew["opt"]["m"], 1e-8,
               lambda w: np.abs(w).max() / 127),
              ("v", tnew["opt"]["v"], jnew["opt"]["v"], 1e-8,
               lambda w: 3 * np.abs(w).max() / 127)]
    for name, got, want, atol, quantum in checks:
        want, got = tree_paths(_np_tree(want)), tree_paths(got)
        for key, w in want.items():
            g = got[key].numpy()
            off = np.abs(g - w) > atol + 1e-5 * np.abs(w)
            if not compress:
                assert not off.any(), (name, key, np.abs(g - w).max())
                continue
            # with compression, a gradient that sits on a rounding boundary
            # of its int8 block moves by one quantum (scale = absmax/127)
            # under a ~1e-7 relative difference (~127·1e-7 of the elements):
            # at most 0.1 %, each bounded by what one quantum does to it
            assert off.sum() <= max(1, off.size // 1000), (name, key)
            assert np.all(np.abs(g - w)[off] <= quantum(w)), (name, key)
    assert int(tnew["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
