"""Shared bodies of the port's training parity tests for the families beyond
the dense one (tests/test_torch_train_{moe,mla,families,ssm,hybrid}.py, one
file a few configs, so that xdist's `--dist loadfile` spreads them): a
config's `.smoke()` in f32 with JAX-initialised weights bridged to torch,
numpy inputs from a seed fed to both packages, and the JAX train shape's
options (`repro/launch/train.py`: the reference attention, CE chunks of
min(128, S), remat 'full', MoE groups of min(64, S)).

The attention projections are scaled to their contraction fan-in, as the
dense family's parity tests do (tests/test_torch_train.py `smol`): the
schema init takes the head count as the fan-in, its softmax is near one-hot
and the backward pass amplifies f32 rounding to ~1e-4 of the embedding
gradient in either framework. Rescaled, every gradient leaf agrees to a few
hundredths of the tolerance; the loop tests run from the schema init itself.

Tolerances: the loss atol 1e-5; every gradient leaf atol 1e-5 / rtol 1e-4;
one train step as `tests/test_torch_train.py::test_train_step_matches_jax`
(loss, grad_norm, lr 1e-5 relative; params 1e-2·lr + 1e-5 relative; m and
v 1e-8 + 1e-5 relative; compressed: at most 0.1 % of a leaf one int8
quantum off); train_loop losses atol 1e-4, as the dense family's loop test.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jcfg
from repro.launch import steps as jsteps
from repro.launch.train import train_loop as jtrain_loop
from repro.models import ExecOptions as JaxOpts, build_model as jbuild
from repro.train import compression as jcomp
from repro.train import optimizer as jopt

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import train_loop
from repro_torch.models.registry import build_model
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.tree import tree_paths

BATCH = 4
# the SSD scan needs S a multiple of its smoke chunk (32) to run in the
# reference; the hybrid's S passes its smoke window (64), so the window
# mask is differentiated
SEQ = {"ssm": 64, "hybrid": 96}
# eps 1e-3: at step 1 AdamW moves each param by lr·g/(|g|+eps); with eps
# 1e-8 a gradient within rounding of zero steps by an arbitrary fraction of
# lr in either framework
STEP_OPT = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)
# patch rows at the embedding table's row scale (its schema std): a
# projector maps the image into the embedding space
PATCH_STD = 0.02


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def seq_of(cfg) -> int:
    return SEQ.get(cfg.family, 32)


def jax_options(seq: int) -> JaxOpts:
    """The JAX train loop's `exec_options_for` overrides."""
    return JaxOpts(attn_impl="reference", ce_chunk=min(128, seq),
                   remat="full", moe_group=min(64, seq))


def fan_in_gains(cfg):
    """{layer leaf: variance gain} to the contraction fan-in (chip_smoke's
    `contraction_fan_in`)."""
    if cfg.attn_kind == "mla":
        hp, r = cfg.n_heads_padded, cfg.kv_lora_rank
        return {"wq": hp / cfg.d_model, "wk_b": hp / r, "wv_b": hp / r,
                "wo": 1 / hp}
    gain = {"wq": cfg.n_heads / cfg.d_model,
            "wk": cfg.n_kv_heads / cfg.d_model,
            "wv": cfg.n_kv_heads / cfg.d_model, "wo": 1 / cfg.n_heads}
    if cfg.family == "encdec":
        gain.update({"c" + k: v for k, v in gain.items()})
    return gain


def build_case(arch, **overrides):
    """(cfg, JAX model, rescaled numpy params, port model, numpy batch) of
    the smoke config with `overrides` (config fields) applied."""
    cfg = dataclasses.replace(jcfg(arch).smoke(), **overrides)
    seq = seq_of(cfg)
    jm = jbuild(cfg, jax_options(seq))
    p = np_tree(jm.init(jax.random.key(0)))
    gain = fan_in_gains(cfg)
    groups = {"encdec": ("enc", "dec"), "hybrid": ("attn",),
              "ssm": ()}.get(cfg.family, ("layers",))
    for group in groups:
        p[group] = {k: v * np.float32(gain[k] ** 0.5) if k in gain else v
                    for k, v in p[group].items()}
    opts, _ = tsteps.train_options(seq)
    tm = build_model(dataclasses.replace(get_config(arch).smoke(),
                                         **overrides), opts, device="cpu")
    return cfg, jm, p, tm, make_batch(cfg, seq)


def make_batch(cfg, seq, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, seq)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = (PATCH_STD * rng.standard_normal(
            (BATCH, cfg.n_image_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (BATCH, seq, cfg.d_model)).astype(np.float32)
    return batch


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(batch):
    import torch
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def jax_loss_and_grads(case):
    cfg, jm, p, _, batch = case
    (loss, _), grads = jax.value_and_grad(jm.train_loss, has_aux=True)(
        _jnp(p), _jnp(batch))
    return float(loss), np_tree(grads)


def check_loss_and_grads(case, want):
    cfg, _, p, tm, batch = case
    _, kw = tsteps.train_options(seq_of(cfg))
    loss, grads = tsteps.loss_and_grads(tm, params_from_numpy(p),
                                        _torch(batch), **kw)
    jloss, jgrads = want
    np.testing.assert_allclose(float(loss), jloss, rtol=0, atol=1e-5)
    want_t, got = tree_paths(jgrads), tree_paths(grads)
    assert set(got) == set(want_t)
    for key, w in want_t.items():
        np.testing.assert_allclose(got[key].numpy(), w, atol=1e-5, rtol=1e-4,
                                   err_msg=key)
    return grads


def jax_step(case, compress, n_micro):
    cfg, jm, p, _, batch = case
    gt = (lambda g: jcomp.compress_decompress(g)[0]) if compress else None
    step = jax.jit(jsteps.make_train_step(
        jm, jopt.OptimizerConfig(**STEP_OPT), gt, n_micro=n_micro))
    params = _jnp(p)
    new, met = step({"params": params, "opt": jopt.init_opt_state(params)},
                    _jnp(batch))
    return np_tree(new), {k: float(v) for k, v in met.items()}


def check_step(case, compress, n_micro):
    """`make_train_step` held to the jitted JAX step from the same state, at
    the tolerances and the one-quantum rule of
    tests/test_torch_train.py::test_train_step_matches_jax."""
    cfg, _, p, tm, batch = case
    jnew, jmet = jax_step(case, compress, n_micro)
    _, kw = tsteps.train_options(seq_of(cfg))
    step = tsteps.make_train_step(
        tm, topt.OptimizerConfig(**STEP_OPT),
        tcomp.compress_grads if compress else None, n_micro=n_micro, **kw)
    tp = params_from_numpy(p)
    tnew, tmet = step({"params": tp, "opt": topt.init_opt_state(tp)},
                      _torch(batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), jmet[k], rtol=1e-5,
                                   atol=0, err_msg=k)
    lr = STEP_OPT["peak_lr"]
    checks = [("params", tnew["params"], jnew["params"], 1e-2 * lr,
               lambda w: 2 * lr),
              ("m", tnew["opt"]["m"], jnew["opt"]["m"], 1e-8,
               lambda w: np.abs(w).max() / 127),
              ("v", tnew["opt"]["v"], jnew["opt"]["v"], 1e-8,
               lambda w: 3 * np.abs(w).max() / 127)]
    for name, got, want, atol, quantum in checks:
        want, got = tree_paths(want), tree_paths(got)
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key].numpy()
            off = np.abs(g - w) > atol + 1e-5 * np.abs(w)
            if not compress:
                assert not off.any(), (name, key, np.abs(g - w).max())
                continue
            # with compression, a gradient that sits on a rounding boundary
            # of its int8 block moves by one quantum (scale = absmax/127)
            # under a ~1e-7 relative difference: at most 0.1 % of a leaf,
            # each bounded by what one quantum does to it
            assert off.sum() <= max(1, off.size // 1000), (name, key)
            assert np.all(np.abs(g - w)[off] <= quantum(w)), (name, key)
    assert int(tnew["opt"]["step"]) == jnew["opt"]["step"] == 1


def check_loop(arch, tmp_path, seq=32):
    """JAX's train_loop trains step 0; the port and JAX each resume a copy
    of its directory for 3 more steps: the same data stream and weights,
    the same losses."""
    kw = dict(arch=arch, smoke=True, global_batch=BATCH, seq_len=seq,
              ckpt_every=0, log_every=100)
    jtrain_loop(steps=1, ckpt_dir=str(tmp_path / "run"), **kw)
    for name in ("jax", "port"):
        shutil.copytree(tmp_path / "run", tmp_path / name)
    jl, _ = jtrain_loop(steps=4, ckpt_dir=str(tmp_path / "jax"), **kw)
    tl, _ = train_loop(steps=4, ckpt_dir=str(tmp_path / "port"),
                       device="cpu", **kw)
    assert len(jl) == len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
