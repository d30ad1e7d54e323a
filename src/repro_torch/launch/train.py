"""End-to-end training driver for the PyTorch port (port of
`repro/launch/train.py`).

Wires the same layers together, in the same order: data pipeline → train
step → checkpoint manager (atomic, integrity-hashed, retention-k) → elastic
heartbeat → resume-on-restart. `--compress-grads` runs every gradient leaf
through the int8 block quantizer (the hand-written `quantize_blocks` /
`dequantize_blocks` CUDA kernels on the card) before clipping and AdamW.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 100 --batch 8 --seq 512 --ckpt-dir /tmp/ckpt [--compress-grads]

Runs the model at its full published width on the CUDA device unless
`--smoke` (the reduced same-family config) or `--device cpu` is given. The
weights are random, drawn from `--seed`. One card only: model parallelism
(`launch/mesh.py`) has no counterpart here yet.

As in the reference, the compressed path passes `compress_decompress(g)[0]`
as the step's `grad_transform`: the error-feedback residual is dropped each
step (recorded in ROADMAP queue C).

The projections, the reference attention, the LM head and the CE are plain
`torch.einsum` (the JAX package leaves them to XLA). Their f32 products run
in full f32: the port leaves `torch.backends.cuda.matmul.allow_tf32` at
PyTorch's default, False, and sets no matmul precision.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

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
               n_micro: int = 1, compress_grads: bool = False, device=None):
    """Train `steps` steps (resuming from the latest checkpoint in
    `ckpt_dir`); returns (losses of the steps run here, final state)."""
    if model_parallel != 1:
        raise NotImplementedError(
            "model_parallel > 1 needs a device mesh: ROADMAP A12 (sharding) "
            "and A14 (parallel/*)")
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    model = build_model(cfg, device=device)
    opt_cfg = opt_mod.OptimizerConfig(peak_lr=peak_lr, warmup_steps=20,
                                      total_steps=steps)

    grad_transform = None
    if compress_grads:
        from repro_torch.train import compression
        grad_transform = lambda g: compression.compress_decompress(g)[0]  # noqa: E731

    step_fn = steps_mod.make_train_step(model, opt_cfg,
                                        grad_transform=grad_transform,
                                        n_micro=n_micro,
                                        ce_chunk=min(128, seq_len),
                                        remat="full")

    mgr = CheckpointManager(ckpt_dir)
    start_step = 0
    if resume and mgr.latest_step() is not None:
        state, manifest = mgr.restore(device=model.device)
        start_step = manifest["step"] + 1
        print(f"[train] resumed from step {manifest['step']} "
              f"(root {manifest['root_hash'][:12]}…)", flush=True)
    else:
        state = steps_mod.init_train_state(model, seed)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=global_batch, seed=seed)
    it = PrefetchIterator(TokenSource(data_cfg), start_step=start_step)
    registry = HeartbeatRegistry(n_hosts=1, policy=ElasticPolicy())

    losses = []
    saved = None
    t_last = time.time()
    try:
        for step, batch in it:
            if step >= steps:
                break
            batch = {k: torch.as_tensor(v, device=model.device)
                     for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))     # waits for the step
            dt = time.time() - t_last
            t_last = time.time()
            registry.beat(0, step_time_s=dt)
            decision = plan_migration(registry)
            if decision.kind != "none":
                print(f"[elastic] {decision.kind}: {decision.reason}", flush=True)
            if step % log_every == 0:
                print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt*1e3:.1f} ms",
                      flush=True)
            if ckpt_every and step and step % ckpt_every == 0:
                path = mgr.save(step, state, extra={"loss": losses[-1]})
                saved = step
                print(f"[ckpt] saved {path}", flush=True)
    finally:
        it.close()
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
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args(argv)
    losses, _ = train_loop(
        arch=args.arch, smoke=args.smoke, steps=args.steps,
        global_batch=args.batch, seq_len=args.seq, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, model_parallel=args.model_parallel,
        peak_lr=args.lr, n_micro=args.n_micro,
        compress_grads=args.compress_grads, device=args.device)
    if losses:
        print(f"[train] done. loss {losses[0]:.3f} → {losses[-1]:.3f} "
              f"over {len(losses)} steps")
    return losses


if __name__ == "__main__":
    main()
