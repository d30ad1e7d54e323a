"""Port parity, dense flash attention and the full-sequence attention path:
the port's `kernels.ops.flash_attention` (its plain version on CPU tensors),
`models.attention.chunked_attention` and `attention` against the JAX
package's Pallas kernel in interpret mode, its reference and its
`chunked_attention`, and the port's monolithic `prefill` logits against
JAX's on a prompt long enough for the blockwise branch, all on numpy inputs
from a seed.

Tolerances: f32 attention `atol=rtol=2e-5` against the kernel (another
online-softmax order) and 1e-5 against the same blockwise loop; bf16 2e-2,
the JAX package's own bf16 bar (tests/test_kernels.py); prefill logits
1e-4, the model parity tests' bar (tests/test_torch_model.py). The CUDA
kernel itself is held to the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jbuild
from repro.models import attention as jattn

from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import attention as tattn
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import ExecOptions

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _np(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _t(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_flash_attention_matches_jax_kernel(causal, window):
    q, k, v = (_np((1, 2, 256, 64), s) for s in (1, 2, 3))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window).numpy()
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, interpret=True))
    ref = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(
        flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                            window=window).numpy(), got, rtol=0, atol=0)


def test_flash_attention_bf16_matches_jax_kernel():
    q, k, v = (_np((2, 2, 256, 128), s).astype(ml_dtypes.bfloat16)
               for s in (4, 5, 6))
    got = ops.flash_attention(_t(q), _t(k), _t(v))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True),
        np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("s,causal,window,g", [
    (256, True, 0, 1), (512, True, 0, 1), (512, False, 0, 1),
    (512, True, 64, 1), (256, True, 0, 3)])
def test_chunked_attention_matches_jax(s, causal, window, g):
    q = _np((2, s, 2, g, 32), 7 + s)
    k, v = _np((2, s, 2, 32), 8 + s), _np((2, s, 2, 32), 9 + s)
    kw = dict(causal=causal, window=window, q_chunk=128, kv_chunk=128)
    want = np.asarray(jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_chunked_attention_matches_flash_layout():
    """The model layout (B,S,H,1,D) through `chunked_attention` equals the
    kernel layout (B,H,S,D) through `ops.flash_attention`, as the JAX
    package holds its kernel to its chunked attention."""
    q, k, v = (_np((2, 256, 4, 64), s) for s in (10, 11, 12))
    got = tattn.chunked_attention(_t(q)[:, :, :, None], _t(k), _t(v),
                                  q_chunk=128, kv_chunk=128)[:, :, :, 0]
    flash = ops.flash_attention(*(_t(x).transpose(1, 2) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), flash.transpose(1, 2).numpy(),
                               **TOL)


@pytest.mark.parametrize("s,impl", [(200, "chunked"), (300, "chunked"),
                                    (300, "reference")])
def test_attention_dispatch_matches_jax(s, impl):
    """S <= 256 and impl="reference" take the oracle, longer sequences the
    blockwise branch (one block at the default 1024 chunk)."""
    q = _np((1, s, 3, 1, 32), 13)
    k, v = _np((1, s, 3, 32), 14), _np((1, s, 3, 32), 15)
    want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), impl=impl))
    got = tattn.attention(_t(q), _t(k), _t(v), impl=impl).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_logits_match_jax_on_the_chunked_branch():
    """A 300-token prompt: every layer's attention takes the blockwise
    branch in both frameworks (JAX's default ExecOptions). Layer 0's K rows
    come before any attention and are held at the same bar; the later
    layers' rows sit behind the schema init's near-one-hot softmax
    (ROADMAP C), which the logits already cover."""
    cfg = get_config("smollm-360m").smoke()
    jm = jbuild(cfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (1, 300)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    for opts in (None, ExecOptions(attn_impl="reference")):
        tm = build_model(cfg, opts, device="cpu")
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(tc["k"][0].numpy(),
                                   np.asarray(jc["k"][0]), atol=1e-4,
                                   rtol=1e-4)


def test_cuda_wrapper_refuses_cpu_tensors_and_mixed_dtypes():
    """The kernel wrapper takes CUDA tensors only: the CPU path is the
    dispatcher's choice (`ops.flash_attention`), never a fallback inside it."""
    q = torch.zeros(1, 2, 32, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fmod.flash_attention_cuda(q, q, q)
    with pytest.raises(TypeError, match="dtypes"):
        fmod.flash_attention_cuda(q, q.double(), q)
    assert fmod.DENSE_LAUNCHES == {}
