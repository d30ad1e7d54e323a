"""Port parity, training the moe family with GQA attention: qwen2-moe-a2.7b
(shared expert, sigmoid-gated) and dbrx-132b `.smoke()` in f32 (the MLA
config, deepseek-v2-lite: tests/test_torch_train_mla.py), through the port's `train_loss` and `make_train_step` against the
JAX package's `value_and_grad` and jitted train step, and the port's
`train_loop` against the JAX loop. The MoE groups are the JAX loop's
(min(64, S) = 32 tokens, four groups a layer here): gradients flow through
`combine` into the router's top-k gates, not through the one-hot positions.
Bodies and tolerances: tests/torch_train_parity.py."""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.train import compression as jcomp

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import steps as tsteps
from repro_torch.train import compression as tcomp
from repro_torch.tree import tree_paths

import torch_train_parity as tp

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

ARCHS = ["qwen2-moe-a2.7b", "dbrx-132b"]


@pytest.fixture(scope="module")
def cases():
    """arch → (case, JAX (loss, grads)), each built once a module."""
    built = {}

    def case(arch):
        if arch not in built:
            c = tp.build_case(arch)
            built[arch] = (c, tp.jax_loss_and_grads(c))
        return built[arch]
    return case


def test_train_options_are_the_jax_loops():
    """`steps.train_options` equals the train loop's `exec_options_for`
    with its overrides (repro/launch/train.py), field for field."""
    for seq in (32, 512, 4096):
        shape = ShapeConfig("train_loop", "train", seq, 4)
        want = jsteps.exec_options_for(
            tp.jcfg(ARCHS[0]), shape, make_host_mesh(model=1),
            {"attn_impl": "reference", "ce_chunk": min(128, seq),
             "act_seq_shard": False, "moe_group": min(64, seq)})
        opts, kw = tsteps.train_options(seq)
        assert (opts.attn_impl, opts.moe_group, kw["ce_chunk"], kw["remat"]) \
            == (want.attn_impl, want.moe_group, want.ce_chunk, want.remat)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(cases, arch):
    case, want = cases(arch)
    tp.check_loss_and_grads(case, want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax(cases, arch, compress, n_micro):
    tp.check_step(cases(arch)[0], compress, n_micro)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_matches_jax(arch, tmp_path):
    tp.check_loop(arch, tmp_path)


def test_compress_grads_is_compress_decompress(cases):
    """The loop's residual-free transform equals `compress_decompress`'s
    first output bit for bit on a real expert gradient tree (the JAX
    package's, bridged; -0.0 kept apart from 0.0), and JAX's own."""
    _, (_, grads) = cases(ARCHS[0])
    tgrads = params_from_numpy(grads)
    got = tree_paths(tcomp.compress_grads(tgrads))
    want = tree_paths(tcomp.compress_decompress(tgrads)[0])
    jwant = tree_paths(tp.np_tree(jcomp.compress_decompress(
        jax.tree.map(jax.numpy.asarray, grads))[0]))
    assert set(got) == set(want) == set(jwant)
    for k, g in got.items():
        assert g.dtype == torch.float32
        assert torch.equal(g.view(torch.int32), want[k].view(torch.int32)), k
        assert g.numpy().tobytes() == jwant[k].tobytes(), k


def test_train_loop_cuts_depth(tmp_path):
    """`layers` cuts the depth, every width as published: the state's
    layer stacks have that many layers."""
    _, state = tp.train_loop(arch=ARCHS[0], smoke=True, steps=1,
                             global_batch=2, seq_len=16, layers=1,
                             ckpt_dir=str(tmp_path), device="cpu")
    cfg = get_config(ARCHS[0]).smoke()
    for k, v in state["params"]["layers"].items():
        assert v.shape[0] == 1, k
    assert state["params"]["layers"]["w1"].shape[1:] == (
        cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    assert np.isfinite(float(state["opt"]["step"]))
