"""End-to-end training driver for the PyTorch port (port of
`repro/launch/train.py`).

Wires the same layers together, in the same order: data pipeline → train
step → checkpoint manager (atomic, integrity-hashed, retention-k) → elastic
heartbeat → resume-on-restart. `--compress-grads` runs every gradient leaf
through the int8 block quantizer (the hand-written `quantize_blocks` /
`dequantize_blocks` CUDA kernels on the card) before clipping and AdamW.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 100 --batch 8 --seq 512 --ckpt-dir /tmp/ckpt [--compress-grads]

The step is compiled once, as the reference jits it (`jax.jit(step,
donate_argnums=(0,))`): `steps.CapturedTrainStep` builds one program for
the batch signature, after a resume too, and every later step replays it.
On the card that program is a CUDA graph (forward, backward, the
quantizers and AdamW), the state written in place and each batch copied
into its static buffers; `--eager` (`train_loop(eager=True)`) runs the
same step per op on the same buffers, as it always runs on the CPU. The
loop prints the builds and replays when it ends.

Runs the model at its full published width on the CUDA device unless
`--smoke` (the reduced same-family config) or `--device cpu` is given;
`--layers N` cuts the depth. Every family but encdec trains here, with the
JAX loop's train shape (`steps.train_options`: the reference attention,
MoE groups of min(64, S) tokens). The encdec family needs 'frames', which
the token source does not yield: the loop refuses it, where the reference
loop fails with KeyError (ROADMAP C); its train step runs with
`registry.train_inputs`. The weights are random, drawn from the seed. One
card only: model parallelism (`launch/mesh.py`) has no counterpart here
yet.

As in the reference, the compressed path applies `compress_decompress(g)[0]`
to the step's gradients (`compression.compress_grads`, which never forms
the residual tree): the error-feedback residual is dropped each step
(recorded in ROADMAP queue C).

The projections, the reference attention, the LM head and the CE are plain
`torch.einsum` (the JAX package leaves them to XLA). Their f32 products run
in full f32: the port leaves `torch.backends.cuda.matmul.allow_tf32` at
PyTorch's default, False, and sets no matmul precision.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, TokenSource
from repro_torch.launch import steps as steps_mod
from repro_torch.models.registry import build_model
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import (
    ElasticPolicy, HeartbeatRegistry, plan_migration)


def train_loop(*, arch: str, smoke: bool, steps: int, global_batch: int,
               seq_len: int, ckpt_dir: str, ckpt_every: int = 50,
               model_parallel: int = 1, peak_lr: float = 3e-4,
               log_every: int = 10, resume: bool = True, seed: int = 0,
               n_micro: int = 1, compress_grads: bool = False, device=None,
               layers: Optional[int] = None, eager: bool = False):
    """Train `steps` steps (resuming from the latest checkpoint in
    `ckpt_dir`); returns (losses of the steps run here, final state).
    `layers` cuts a decoder-only, ssm or hybrid config to that many
    layers, every width as published. The step runs as a CUDA graph on the
    card unless `eager` (`steps.CapturedTrainStep`)."""
    if model_parallel != 1:
        raise NotImplementedError(
            "model_parallel > 1 needs a device mesh: ROADMAP A12 (sharding) "
            "and A14 (parallel/*)")
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    if cfg.family == "encdec":
        raise ValueError(
            f"train_loop cannot train {cfg.name!r}: the encdec family needs "
            "'frames', and the token source yields only 'tokens' and "
            "'labels' (the reference loop fails on the same batch with "
            "KeyError: 'frames'; ROADMAP C); use launch.steps."
            "make_train_step with models.registry.train_inputs")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    opts, step_kw = steps_mod.train_options(seq_len)
    model = build_model(cfg, opts, device=device)
    opt_cfg = opt_mod.OptimizerConfig(peak_lr=peak_lr, warmup_steps=20,
                                      total_steps=steps)

    grad_transform = None
    if compress_grads:
        from repro_torch.train import compression
        grad_transform = compression.compress_grads

    step_fn = steps_mod.make_train_step(model, opt_cfg,
                                        grad_transform=grad_transform,
                                        n_micro=n_micro, **step_kw)

    mgr = CheckpointManager(ckpt_dir)
    start_step = 0
    if resume and mgr.latest_step() is not None:
        state, manifest = mgr.restore(device=model.device)
        start_step = manifest["step"] + 1
        print(f"[train] resumed from step {manifest['step']} "
              f"(root {manifest['root_hash'][:12]}…)", flush=True)
    else:
        state = steps_mod.init_train_state(model, seed)
    # built on the restored state: a resumed run builds once too
    step = steps_mod.CapturedTrainStep(step_fn, state, eager=eager)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=global_batch, seed=seed)
    it = PrefetchIterator(TokenSource(data_cfg), start_step=start_step)
    registry = HeartbeatRegistry(n_hosts=1, policy=ElasticPolicy())

    losses = []
    saved = None
    t_last = time.time()
    try:
        for i, batch in it:
            if i >= steps:
                break
            state, metrics = step(state, batch)   # numpy: staged, one copy
            losses.append(float(metrics["loss"]))     # waits for the step
            dt = time.time() - t_last
            t_last = time.time()
            registry.beat(0, step_time_s=dt)
            decision = plan_migration(registry)
            if decision.kind != "none":
                print(f"[elastic] {decision.kind}: {decision.reason}", flush=True)
            if i % log_every == 0:
                print(f"[train] step {i:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt*1e3:.1f} ms",
                      flush=True)
            if ckpt_every and i and i % ckpt_every == 0:
                path = mgr.save(i, state, extra={"loss": losses[-1]})
                saved = i
                print(f"[ckpt] saved {path}", flush=True)
    finally:
        it.close()
    print(f"[train] step program: builds {step.builds} "
          f"({'CUDA graph' if step.captured else 'per op'}), "
          f"replays {step.replays}", flush=True)
    last = min(steps - 1, start_step + len(losses) - 1)
    if losses and last != saved:    # the loop may have just saved it
        mgr.save(last, state, extra={"loss": losses[-1]})
    return losses, state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (default: full width)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join("build", "train_ckpt"),
                    help="checkpoint directory, resumed from if it holds one "
                         "(default: build/train_ckpt under the working "
                         "directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers, every width "
                         "as published (default: the config's depth)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--eager", action="store_true",
                    help="run the step per op (default: one CUDA graph a "
                         "batch signature on the card)")
    args = ap.parse_args(argv)
    losses, _ = train_loop(
        arch=args.arch, smoke=args.smoke, steps=args.steps,
        global_batch=args.batch, seq_len=args.seq, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, model_parallel=args.model_parallel,
        peak_lr=args.lr, n_micro=args.n_micro,
        compress_grads=args.compress_grads, device=args.device,
        layers=args.layers, eager=args.eager)
    if losses:
        print(f"[train] done. loss {losses[0]:.3f} → {losses[-1]:.3f} "
              f"over {len(losses)} steps")
    return losses


if __name__ == "__main__":
    main()
