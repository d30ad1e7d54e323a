"""Port parity, training the moe family with MLA attention: deepseek-v2-lite
`.smoke()` in f32 (`models/mla.py` in train mode: the config's direct
query projection, and the low-rank one (q_lora_rank 16, as the 236B
model's 1536) for the loss and gradients),
through the port's `train_loss` and `make_train_step` against the JAX
package's `value_and_grad` and jitted train step, and the port's
`train_loop` against the JAX loop. Bodies and tolerances:
tests/torch_train_parity.py."""

import pytest
import torch

import torch_train_parity as tp

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

ARCH = "deepseek-v2-lite"


@pytest.fixture(scope="module")
def case():
    c = tp.build_case(ARCH)
    return c, tp.jax_loss_and_grads(c)


def test_loss_and_grads_match_jax(case):
    tp.check_loss_and_grads(*case)


def test_low_rank_query_loss_and_grads_match_jax():
    c = tp.build_case(ARCH, q_lora_rank=16)
    assert "wq_a" in c[2]["layers"] and "wq" not in c[2]["layers"]
    tp.check_loss_and_grads(c, tp.jax_loss_and_grads(c))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax(case, compress, n_micro):
    tp.check_step(case[0], compress, n_micro)


def test_train_loop_matches_jax(tmp_path):
    tp.check_loop(ARCH, tmp_path)
