"""Port parity, substrate: the weights bridge, norms/activations/rope and the
int8 quantizers of `repro_torch` against the JAX package, on inputs made with
numpy from a seed. Tolerances: f32 ops `atol=rtol=1e-5` (the same math in
another summation order); quantizer bytes and scales bit-identical."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.int8_matmul import int8_matmul as jax_int8_matmul
from repro.kernels import ref as jref
from repro.models import ExecOptions, build_model
from repro.models import common as jcommon
from repro.models import quantized as jq

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.kernels import ref as tref
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.models import common as tcommon
from repro_torch.models import quantized as tq

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _same_bytes(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype.itemsize == b.dtype.itemsize and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def smol_np():
    cfg = get_config("smollm-360m").smoke()
    model = build_model(cfg, ExecOptions(attn_impl="reference"))
    return cfg, jax.tree.map(np.asarray, model.init(jax.random.key(0)))


# ------------------------------------------------------------------ bridge
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.int8])
def test_bridge_round_trip_bit_equal(dtype):
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((3, 5, 7)) * 50).astype(dtype)
    tree = {"layers": {"w": a, "q": {"int8_q": a.astype(np.int8),
                                     "s": a.astype(np.float32)}}}
    t = params_from_numpy(tree, "cpu")
    want = {np.float32: torch.float32, np.int8: torch.int8}.get(
        dtype, torch.bfloat16)
    assert t["layers"]["w"].dtype == want
    assert t["layers"]["q"]["int8_q"].dtype == torch.int8
    back = params_to_numpy(t)
    assert back["layers"]["w"].dtype == a.dtype
    assert _same_bytes(back["layers"]["w"], a)
    assert _same_bytes(back["layers"]["q"]["int8_q"], a.astype(np.int8))


def test_bridge_jax_params_keep_names_and_layer_axis(smol_np):
    cfg, p = smol_np
    t = params_from_numpy(p, "cpu")
    assert set(t) == set(p) and set(t["layers"]) == set(p["layers"])
    for k, v in p["layers"].items():
        assert tuple(t["layers"][k].shape) == v.shape
        assert t["layers"][k].shape[0] == cfg.n_layers
        assert _same_bytes(t["layers"][k].numpy(), v)


def test_bridge_bf16_jax_params_bit_equal():
    cfg = get_config("smollm-360m").smoke()
    model = build_model(cfg, ExecOptions(attn_impl="reference"))
    p = jax.tree.map(np.asarray, model.init(jax.random.key(1), jnp.bfloat16))
    t = params_from_numpy(p, "cpu")
    assert t["embed"].dtype == torch.bfloat16
    assert _same_bytes(t["embed"].view(torch.int16).numpy(),
                       p["embed"].view(np.int16))


def test_init_params_distributions():
    """Same distributions as the JAX schema init: zeros/ones exact, normals
    at std scale/sqrt(fan_in) (fan_in = shape[-2]) and 0.02 small_normal."""
    from repro_torch.models.transformer import schema
    cfg = get_config("smollm-360m").smoke()
    gen = torch.Generator().manual_seed(0)
    p = tcommon.init_params(schema(cfg), gen, torch.float32, "cpu")
    assert torch.all(p["final_norm"] == 1)
    w1 = p["layers"]["w1"]                                   # (L, d, f)
    assert abs(w1.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(p["embed"].std().item() - 0.02) < 0.002
    wq = p["layers"]["wq"]                                   # (L, d, h, k)
    assert abs(wq.std().item() - wq.shape[-2] ** -0.5) < 0.1 * wq.shape[-2] ** -0.5


# ------------------------------------------------------ norms / act / rope
def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal((64,)).astype(np.float32)
    for plus_one in (False, True):
        want = _np(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w),
                                    plus_one=plus_one))
        got = tcommon.rms_norm(_t(x), _t(w), plus_one=plus_one).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("grad", [False, True])
def test_rms_norm_sum_by_autograd(grad):
    """Without autograd the mean of squares is the f64 sum rounded to f32;
    under a graph that records gradients it is the reference's f32 sum.
    Both stay within the JAX norm's tolerance and give the same dtype."""
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((3, 4, 960)).astype(np.float32) * 3)
    w = _t(rng.standard_normal((960,)).astype(np.float32)).requires_grad_(grad)
    got = tcommon.rms_norm(x, w)
    xf = x.double() if not grad else x
    var = torch.mean(xf * xf, dim=-1, keepdim=True).float()
    want = x * torch.rsqrt(var + 1e-6) * w
    assert torch.equal(got, want) and got.requires_grad == grad
    ref = _np(jcommon.rms_norm(jnp.asarray(x.numpy()),
                               jnp.asarray(w.detach().numpy())))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5, rtol=1e-5)
    if grad:
        got.sum().backward()
        assert w.grad is not None and torch.isfinite(w.grad).all()


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_act_fn_matches_jax(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    want = _np(jcommon.act_fn(name)(jnp.asarray(x)))
    got = tcommon.act_fn(name)(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert tcommon.glu_act("swiglu") == jcommon.glu_act("swiglu")


def test_softcap_matches_jax():
    x = np.linspace(-100, 100, 51, dtype=np.float32)
    want = _np(jcommon.softcap(jnp.asarray(x), 30.0))
    np.testing.assert_allclose(tcommon.softcap(_t(x), 30.0).numpy(), want,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_jax(fraction):
    """Interleaved (even, odd) pairs; partial rotary leaves the tail alone."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 900, (2, 7)).astype(np.int32)
    want = _np(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                  fraction=fraction, theta=1e4))
    got = tcommon.apply_rope(_t(x), _t(pos), fraction=fraction,
                             theta=1e4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


# -------------------------------------------------------------- quantizers
def test_quantize_kv_rows_bit_identical():
    """int8 bytes and f16 scales equal JAX's: scale rounded to f16 before
    the divide, half-to-even rounding, all-zero rows → (0, 1e-6)."""
    rng = np.random.default_rng(3)
    kv = rng.standard_normal((4, 9, 2, 32)).astype(np.float32)
    kv[0, 0] = 0.0
    kv[1, 2, 0, :4] = [0.5, -0.5, 1.5, 2.5]      # exact .5 ratios
    jqv, jsv = jq.quantize_kv_rows(jnp.asarray(kv))
    tqv, tsv = tq.quantize_kv_rows(_t(kv))
    assert tqv.dtype == torch.int8 and tsv.dtype == torch.float16
    assert _same_bytes(tqv.numpy(), _np(jqv))
    assert _same_bytes(tsv.numpy(), _np(jsv))
    back = tq.dequantize_kv_rows(tqv, tsv).numpy()
    np.testing.assert_array_equal(back, _np(jq.dequantize_kv_rows(jqv, jsv)))


def test_quantize_params_bit_identical(smol_np):
    cfg, p = smol_np
    want = jax.tree.map(np.asarray,
                        jq.quantize_params(jax.tree.map(jnp.asarray, p), cfg))
    got = tq.quantize_params(params_from_numpy(p, "cpu"), cfg)
    for k, v in want["layers"].items():
        if isinstance(v, dict):
            assert _same_bytes(got["layers"][k]["int8_q"].numpy(), v["int8_q"]), k
            assert _same_bytes(got["layers"][k]["s"].numpy(), v["s"]), k
        else:
            assert _same_bytes(got["layers"][k].numpy(), v), k


@pytest.mark.parametrize("eq,xshape,key", [
    ("bsd,dhk->bshk", (2, 3, 128), "wq"),
    ("bsd,dhk->bshk", (2, 3, 128), "wk"),
    ("bshk,hkd->bsd", (2, 3, 5, 32), "wo"),
    ("bsd,df->bsf", (2, 3, 128), "w1"),
    ("bsf,fd->bsd", (2, 3, 256), "w2"),
])
def test_qeinsum_int8_matches_jax(smol_np, eq, xshape, key):
    """qeinsum's 2-D reshape (scale flattened in output-dim order) against
    the JAX qeinsum (jnp path; f32 accumulate in another order)."""
    cfg, p = smol_np
    qp = jax.tree.map(np.asarray, jq.quantize_params(
        jax.tree.map(jnp.asarray, p), cfg))["layers"][key]
    w = {"int8_q": qp["int8_q"][0], "s": qp["s"][0]}
    x = np.random.default_rng(4).standard_normal(xshape).astype(np.float32)
    want = _np(jq.qeinsum(eq, jnp.asarray(x), jax.tree.map(jnp.asarray, w),
                          impl="jnp"))
    got = tq.qeinsum(eq, _t(x), {k: _t(v) for k, v in w.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    plain = tq.qeinsum(eq, _t(x), _t(np.asarray(p["layers"][key][0]))).numpy()
    np.testing.assert_allclose(
        plain, np.einsum(eq, x, p["layers"][key][0]), atol=1e-4, rtol=1e-4)


def test_int8_matmul_ref_matches_jax_kernel_interpret():
    """The port's plain int8 matmul against the Pallas kernel (interpret)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 256)).astype(np.float32)
    wq = rng.integers(-127, 128, (256, 128)).astype(np.int8)
    s = (rng.random(128).astype(np.float32) + 0.5) / 127
    want = _np(jax_int8_matmul(jnp.asarray(x), jnp.asarray(wq),
                               jnp.asarray(s), interpret=True))
    got = tref.int8_matmul_ref(_t(x), _t(wq), _t(s)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(int8_matmul(_t(x), _t(wq), _t(s)).numpy(),
                                  got)


def test_block_quantizers_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 300)).astype(np.float32)
    jqb, jsb, n = jref.quantize_blocks_ref(jnp.asarray(x))
    tqb, tsb, tn = tref.quantize_blocks_ref(_t(x))
    assert tn == n
    assert _same_bytes(tqb.numpy(), _np(jqb))
    np.testing.assert_allclose(tsb.numpy(), _np(jsb), rtol=1e-7)
    back = tref.dequantize_blocks_ref(tqb, tsb, tn, x.shape).numpy()
    np.testing.assert_allclose(
        back, _np(jref.dequantize_blocks_ref(jqb, jsb, n, x.shape)),
        atol=1e-6)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    jw, js = jref.quantize_weight_ref(jnp.asarray(w))
    tw, ts = tref.quantize_weight_ref(_t(w))
    assert _same_bytes(tw.numpy(), _np(jw)) and _same_bytes(ts.numpy(), _np(js))


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_imports_nothing_of_jax_or_repro():
    """Every module of the port, chip_smoke.py and the port's design-space
    example, at module level or inside a function: no `jax`, `jaxlib`,
    `repro` or `repro.*` import."""
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files += [root / "chip_smoke.py", root / "examples" / "design_space_torch.py"]
    assert len(files) > 20
    bad = []
    for path in files:
        for mod in _imported_modules(ast.parse(path.read_text())):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(root)}: {mod}")
    assert not bad, bad


def test_flash_attention_ref_matches_jax():
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 2, 24, 32)).astype(np.float32)
               for _ in range(3))
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        want = _np(jref.flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window))
        got = tref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                       window=window).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
