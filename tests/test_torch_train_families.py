"""Port parity, training the vlm and encdec families: llava-next-mistral-7b
`.smoke()` with `patch_embeds` over its leading positions (which carry no
label) and seamless-m4t-medium `.smoke()` with `frames` through the encoder
and the cross attention, in f32, through the port's `train_loss` and
`make_train_step` against the JAX package's `value_and_grad` and jitted
train step; the vlm `train_loop` (text only, as the JAX loop feeds it)
against the JAX loop; and the encdec loop's refusal against the JAX loop's
KeyError. Also the train inputs (`registry.train_inputs`) against the JAX
`input_specs`. Bodies and tolerances: tests/torch_train_parity.py."""

import pytest
import torch

from repro.configs import get_config as jcfg
from repro.configs.base import ShapeConfig
from repro.launch.train import train_loop as jtrain_loop
from repro.models import registry as jregistry

from repro_torch.configs import get_config
from repro_torch.models.registry import train_input_shapes, train_inputs

import torch_train_parity as tp

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

ARCHS = ["llava-next-mistral-7b", "seamless-m4t-medium"]
ALL = ["qwen2-moe-a2.7b", "deepseek-v2-lite", "dbrx-132b",
       "llava-next-mistral-7b", "seamless-m4t-medium", "mamba2-780m",
       "recurrentgemma-2b"]


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


@pytest.mark.parametrize("arch", ALL)
def test_train_inputs_match_input_specs(arch):
    """The keys and shapes of the JAX train shape's `input_specs`, at full
    width and at smoke size; ints in [0, vocab), seeded, on the device
    asked for."""
    for cfg, tcfg in ((jcfg(arch), get_config(arch)),
                      (jcfg(arch).smoke(), get_config(arch).smoke())):
        specs = jregistry.input_specs(cfg, ShapeConfig("t", "train", 64, 2))
        assert train_input_shapes(tcfg, 2, 64) == {
            k: tuple(v.shape) for k, v in specs.items()}
    tcfg = get_config(arch).smoke()
    a = train_inputs(tcfg, 2, 64, seed=3, device="cpu")
    b = train_inputs(tcfg, 2, 64, seed=3, device="cpu")
    for k, v in a.items():
        assert torch.equal(v, b[k]) and v.device.type == "cpu"
        want = torch.int32 if k in ("tokens", "labels") else torch.bfloat16
        assert v.dtype == want, k
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < \
        tcfg.vocab_size
    c = train_inputs(tcfg, 2, 64, seed=4, device="cpu")
    assert not torch.equal(a["tokens"], c["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(cases, arch):
    case, want = cases(arch)
    grads = tp.check_loss_and_grads(case, want)
    if arch.startswith("llava"):
        # the image positions carry no label: their patch rows are inputs,
        # and the token embeddings they replace get no gradient from them
        cfg, _, _, _, batch = case
        image_tok = set(batch["tokens"][:, :cfg.n_image_tokens].ravel())
        text_tok = set(batch["tokens"][:, cfg.n_image_tokens:].ravel())
        for t in image_tok - text_tok:
            assert not grads["embed"][int(t)].any(), t


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax(cases, arch, compress, n_micro):
    tp.check_step(cases(arch)[0], compress, n_micro)


def test_vlm_train_loop_matches_jax(tmp_path):
    tp.check_loop(ARCHS[0], tmp_path)


def test_encdec_train_loop_refused_as_the_reference_fails(tmp_path):
    """The token source yields no 'frames': the JAX loop fails with
    KeyError on seamless-m4t-medium, the port's refuses it naming that."""
    kw = dict(arch=ARCHS[1], smoke=True, steps=1, global_batch=2, seq_len=16,
              ckpt_every=0, log_every=100)
    with pytest.raises(KeyError, match="frames"):
        jtrain_loop(ckpt_dir=str(tmp_path / "jax"), **kw)
    with pytest.raises(ValueError, match="KeyError: 'frames'"):
        tp.train_loop(ckpt_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert not (tmp_path / "port").exists()
