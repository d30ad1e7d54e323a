#!/usr/bin/env python3
"""How the gradient norm at the schema init grows with depth, in the JAX
package and in the PyTorch port, on the CPU.

    PYTHONPATH=src python tools/torch_grad_depth.py

smollm-360m `.smoke()` (d_model 128, float32) at 2, 4, 8 and 16 layers,
JAX-initialised weights bridged to the port, one batch of the data
pipeline: prints each framework's loss and global gradient norm. Both grow
by the same factor per layer; the schema init's head-count fan-in (ROADMAP
queue C) makes every layer amplify the backward pass, so the full-width
model's 32 layers reach the ~1e16 norms of chip_smoke.py's train phase.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config
from repro.data import pipeline as jdata
from repro.models import ExecOptions, build_model as jbuild
from repro.train import optimizer as jopt

from repro_torch.bridge import params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.models.registry import build_model
from repro_torch.train import optimizer as topt


def main():
    base = get_config("smollm-360m").smoke()
    batch = jdata.TokenSource(jdata.DataConfig(base.vocab_size, 32, 4)).batch_at(0)
    for n_layers in (2, 4, 8, 16):
        cfg = dataclasses.replace(base, n_layers=n_layers)
        jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=32))
        p = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
        (jloss, _), jgrads = jax.value_and_grad(jm.train_loss, has_aux=True)(
            jax.tree.map(jnp.asarray, p),
            {k: jnp.asarray(v) for k, v in batch.items()})
        tloss, tgrads = tsteps.loss_and_grads(
            build_model(cfg, device="cpu"), params_from_numpy(p),
            {k: torch.from_numpy(v) for k, v in batch.items()},
            ce_chunk=32, remat="none")
        print(f"{n_layers:2d} layers: loss JAX {float(jloss):.5f} port "
              f"{float(tloss):.5f}; gradient norm JAX "
              f"{float(jopt.global_norm(jgrads)):.6g} port "
              f"{float(topt.global_norm(tgrads)):.6g}")


if __name__ == "__main__":
    main()
