"""Port parity, block quantizers: `repro_torch.kernels.ops.quantize_blocks` /
`dequantize_blocks` against the JAX package's (`repro.kernels.ops`, whose
Pallas kernels run in interpret mode on the CPU), on inputs made with numpy
from a seed. On the CPU the port takes the plain versions, the functions its
CUDA kernels are held to bit for bit on the card.

Tolerance: none. The int8 bytes, the f32 scales, `n` and the shapes are
bit-identical; a block holding a NaN has a NaN scale in both, and its int8
values (undefined) are not compared."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as kq

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)


def _same_bytes(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype.itemsize == b.dtype.itemsize and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _gradient_like(rng, n):
    """Values at a different scale in every 256-block, as gradients are."""
    blocks = -(-n // 256)
    scale = np.exp(rng.uniform(-12, 4, blocks)).repeat(256)[:n]
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _both(x):
    """(JAX q, s, n) and (port q, s, n) as numpy, for the same input."""
    jq, js, jn = jops.quantize_blocks(jnp.asarray(x))
    tq, ts, tn = tops.quantize_blocks(tensor_from_numpy(x))
    return (np.asarray(jq), np.asarray(js), jn), (tq.numpy(), ts.numpy(), tn)


def _check_equal(x, shape=None):
    (jq, js, jn), (tq, ts, tn) = _both(x)
    assert tn == jn == x.size
    assert tq.shape == jq.shape and ts.shape == js.shape
    assert jq.shape[0] % 8 == 0 and jq.shape[1] == 256    # whole grid tiles
    assert _same_bytes(tq, jq)
    assert _same_bytes(ts, js)
    shape = shape or x.shape
    want = np.asarray(jops.dequantize_blocks(jnp.asarray(jq), jnp.asarray(js),
                                             jn, shape))
    got = tops.dequantize_blocks(torch.from_numpy(tq), torch.from_numpy(ts),
                                 tn, shape).numpy()
    assert got.shape == want.shape and _same_bytes(got, want)
    return tq, ts


@pytest.mark.parametrize("n", [1, 255, 256, 2048, 2049, 5000])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_quantize_blocks_bit_identical(n, dtype):
    x = _gradient_like(np.random.default_rng(n), n).astype(dtype)
    _check_equal(x)


def test_quantize_blocks_multi_dim_leaf():
    x = _gradient_like(np.random.default_rng(1), 3 * 7 * 130).reshape(3, 7, 130)
    _check_equal(x)


def test_all_zero_tensor():
    tq, ts = _check_equal(np.zeros((3, 700), np.float32))
    assert not tq.any()
    assert np.all(ts == np.float32(1e-12) * np.float32(1 / 127))


def test_tie_block_rounds_half_to_even():
    """absmax 127 makes the scale exactly 1.0, so k + 0.5 values are exact
    ties: half to even, as jnp.round and torch.round."""
    x = np.zeros(2048, np.float32)
    x[:6] = [0.5, 1.5, 2.5, -0.5, -1.5, 126.5]
    x[6] = 127.0
    tq, ts = _check_equal(x)
    assert ts[0] == 1.0
    assert tq[0, :7].tolist() == [0, 2, 2, 0, -2, 126, 127]


def test_absmax_maps_to_127_never_minus_128():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    x[0, 3], x[1, 9], x[2, 0], x[3, 255] = 5.0, -5.0, -7.25, 7.25
    tq, _ = _check_equal(x)
    assert tq[0, 3] == 127 and tq[1, 9] == -127
    assert tq[2, 0] == -127 and tq[3, 255] == 127
    assert tq.min() >= -127


def test_nan_block_has_nan_scale():
    x = _gradient_like(np.random.default_rng(3), 5 * 256)
    x[2 * 256 + 17] = np.nan
    (jq, js, _), (tq, ts, _) = _both(x)
    assert np.isnan(js[2]) and np.isnan(ts[2])
    finite = ~np.isnan(js)
    assert finite.sum() == len(js) - 1
    assert _same_bytes(ts[finite], js[finite])
    assert _same_bytes(tq[finite], jq[finite])      # the NaN block's q: no


def test_bf16_dequantize_matches_jax():
    """dequantize to bf16: the f32 product rounded to nearest even."""
    x = _gradient_like(np.random.default_rng(4), 4096)
    jq, js, n = jops.quantize_blocks(jnp.asarray(x))
    want = np.asarray(jops.dequantize_blocks(jq, js, n, x.shape,
                                             dtype=jnp.bfloat16))
    got = tops.dequantize_blocks(torch.from_numpy(np.array(jq)),
                                 torch.from_numpy(np.array(js)), n, x.shape,
                                 dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _same_bytes(got.view(torch.int16).numpy(), want.view(np.int16))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CPU dispatch takes the plain version; the *_cuda wrappers take
    CUDA tensors only and never fall back."""
    x = torch.zeros(8, 256)
    with pytest.raises(ValueError):
        kq.quantize_blocks_cuda(x)
    with pytest.raises(ValueError):
        kq.dequantize_blocks_cuda(torch.zeros(8, 256, dtype=torch.int8),
                                  torch.ones(8))
    with pytest.raises(ValueError):
        kq.quantize_blocks_cuda(torch.zeros(8, 128))
    before = dict(kq.LAUNCHES)
    kq.quantize_blocks(x)
    kq.dequantize_blocks(torch.zeros(8, 256, dtype=torch.int8), torch.ones(8))
    assert dict(kq.LAUNCHES) == before
