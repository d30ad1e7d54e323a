"""Port parity, training the hybrid family: recurrentgemma-2b `.smoke()`
(the RG-LRU doubling scan and the local attention, S 96 past its 64-row
window, so the window mask is differentiated) in f32, through the port's
`train_loss` and `make_train_step` against the JAX package's
`value_and_grad` and jitted train step, and the port's `train_loop`
against the JAX loop. Bodies and tolerances: tests/torch_train_parity.py."""

import pytest
import torch

import torch_train_parity as tp

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

ARCHS = ["recurrentgemma-2b"]


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


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(cases, arch):
    tp.check_loss_and_grads(*cases(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax(cases, arch, compress, n_micro):
    tp.check_step(cases(arch)[0], compress, n_micro)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_matches_jax(arch, tmp_path):
    tp.check_loop(arch, tmp_path, seq=tp.SEQ[tp.jcfg(arch).family])
