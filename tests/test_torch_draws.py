"""The port's two weight draws that never hold a full-width float tree:
`ModelApi.init(by_layer=True)` (each layer-stacked leaf drawn one layer
slice at a time) and `ModelApi.init_int8` (each quantized leaf's slices
quantized as they are drawn), at `.smoke()` size on the CPU.

`init_int8` must equal `quantize_params` of the by-layer float draw of
the same seed and transform bit for bit; an engine fed the pre-quantized
tree must serve the tokens and write the pools of one that quantizes the
float tree itself; a by-layer leaf must have the schema's distribution;
and the default `init` keeps its stream. On the card, an engine takes
the pre-quantized tree without copying a byte (`cuda`, skipped here)."""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.common import (
    ParamDef, _std, init_params, is_layer_stacked)
from repro_torch.models.quantized import is_quantized, quantize_params
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.tree import tree_paths

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

# the dense configs, a moe (per-expert scales) and an MLA one
ARCHS = ["smollm-360m", "qwen2.5-32b", "qwen2-moe-a2.7b", "deepseek-v2-lite"]


def halve_attention(path, x):
    """A transform of the kind `chip_smoke.contraction_fan_in` applies: a
    fixed gain on some layer leaves, every other leaf as it is."""
    return x * 0.5 if path[-1] in ("wq", "wk", "wv", "wo") else x


def _model(arch, device="cpu"):
    return build_model(get_config(arch).smoke(), device=device)


def _equal_trees(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert pa.keys() == pb.keys()
    for k in pa:
        assert pa[k].dtype == pb[k].dtype and pa[k].shape == pb[k].shape, k
        assert torch.equal(pa[k], pb[k]), k


@pytest.mark.parametrize("transform", [None, halve_attention])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_int8_equals_quantize_params_of_by_layer_draw(arch, transform):
    """Bit for bit, bf16 and f32 alike: the same slices are drawn in the
    same order and quantized by the same per-slice function."""
    model = _model(arch)
    want = quantize_params(model.init(5, by_layer=True, transform=transform),
                           model.cfg)
    got = model.init_int8(5, transform=transform)
    _equal_trees(want, got)
    assert is_quantized(got["layers"]["w1" if "w1" in got["layers"]
                                      else "wq"])
    # bf16 (the full configs' dtype) too
    bf = model.init(5, dtype=torch.bfloat16, by_layer=True,
                    transform=transform)
    assert bf["layers"]["attn_norm"].dtype == torch.bfloat16
    assert not is_quantized(bf["layers"]["wo"])


def test_quantize_params_passes_quantized_leaves_through():
    """A tree that is already int8 comes back with the very same tensors."""
    model = _model("qwen2.5-32b")
    q = model.init_int8(1)
    again = quantize_params(q, model.cfg)
    for k, v in tree_paths(q).items():
        assert tree_paths(again)[k] is v, k


def test_by_layer_leaf_has_the_schema_distribution():
    """Every slice of a by-layer leaf is a fresh draw with the whole leaf's
    std (its fan-in from the full shape): at qwen2.5-32b's smoke size a
    (2, 128, 256) w1 leaf has mean 0 within 4 standard errors and std
    1/sqrt(128) within 2 %; zeros and ones leaves are exact, and the
    slices differ from each other."""
    model = _model("qwen2.5-32b")
    p = model.init(0, by_layer=True)
    sch = model.schema
    for name in ("w1", "w2", "wq", "wo"):
        d = sch["layers"][name]
        x = p["layers"][name].double()
        n, std = x.numel(), _std(d)
        assert abs(x.mean().item()) < 4 * std / n ** 0.5, name
        assert abs(x.std().item() / std - 1) < 0.02, name
        assert not torch.equal(x[0], x[1]), name
    assert torch.equal(p["layers"]["bq"], torch.zeros_like(p["layers"]["bq"]))
    assert torch.equal(p["layers"]["attn_norm"],
                       torch.ones_like(p["layers"]["attn_norm"]))
    emb = p["embed"].double()
    assert abs(emb.std().item() / _std(sch["embed"]) - 1) < 0.02
    assert is_layer_stacked(sch["layers"]["w1"])
    assert not is_layer_stacked(sch["embed"])


def test_default_draw_keeps_its_stream():
    """`init` without `by_layer` draws each leaf whole, as it always has:
    randn of the leaf's shape in f32 scaled by the schema's std, leaves in
    sorted-key order (so earlier slices' chip runs keep their weights)."""
    model = _model("qwen2.5-32b")
    got = model.init(3)
    gen = torch.Generator().manual_seed(3)
    for path, d in sorted(tree_paths(model.schema).items()):
        if d.init == "zeros":
            want = torch.zeros(d.shape)
        elif d.init == "ones":
            want = torch.ones(d.shape)
        else:
            want = torch.randn(d.shape, generator=gen) * _std(d)
        assert torch.equal(tree_paths(got)[path], want), path
    assert isinstance(model.schema["embed"], ParamDef)
    _equal_trees(got, init_params(model.schema,
                                  torch.Generator().manual_seed(3),
                                  torch.float32))
    with pytest.raises(ValueError, match="by-layer"):
        model.init(3, transform=halve_attention)


@pytest.mark.parametrize("paged,chunked", [(True, True), (False, False)])
def test_engine_takes_the_prequantized_tree(paged, chunked):
    """An int8 engine fed `init_int8`'s tree serves the tokens of one fed
    the by-layer float tree (which quantizes it itself) and writes the same
    pools, and so does an engine with `wdtype=None` fed the int8 tree; they
    keep the tree's tensors as they are."""
    model = _model("qwen2.5-32b")
    float_tree = model.init(2, by_layer=True, transform=halve_attention)
    int8_tree = model.init_int8(2, transform=halve_attention)
    kw = dict(n_slots=2, max_len=64, page_size=8, paged=paged,
              chunked_prefill=chunked, wdtype="int8", kv_dtype="int8",
              device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 19, 30)]
    engines, tokens = [], []
    for tree in (float_tree, int8_tree):
        eng = ServeEngine(model, params=tree, **kw)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_to_completion()
        engines.append(eng)
        tokens.append([r.out_tokens for r in reqs])
    # an int8 tree under wdtype None serves as given (the dense int8
    # oracle of a sweep takes its weights quantized once this way)
    eng = ServeEngine(model, params=int8_tree, **dict(kw, wdtype=None))
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_to_completion()
    engines.append(eng)
    tokens.append([r.out_tokens for r in reqs])
    assert tokens[0] == tokens[1] == tokens[2]
    # wdtype "bf16" casts the float leaves and keeps the int8 ones
    bf = ServeEngine(model, params=int8_tree, **dict(kw, wdtype="bf16"))
    assert bf.params["embed"].dtype == torch.bfloat16
    for k in ("int8_q", "s"):
        assert bf.params["layers"]["w1"][k] is int8_tree["layers"]["w1"][k]
    for eng in engines[1:]:
        for key, t in engines[0]._cache.items():
            assert torch.equal(t, eng._cache[key]), key
    for eng in engines[1:]:
        kept = tree_paths(eng.params)
        for k, v in tree_paths(int8_tree).items():
            assert kept[k] is v, k


@pytest.mark.cuda
def test_engine_on_the_card_copies_no_weight():
    """On the card: `init_int8`'s tree and a bf16 by-layer tree go into
    their engines with no device memory beyond the pools (no weight is
    copied), and a by-layer draw's peak stays within the tree plus a few
    temporaries of its largest layer slice in f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _model("qwen2.5-32b", device="cuda")
    slice_f32 = max(math.prod(d.shape[1:]) if is_layer_stacked(d) else 0
                    for d in tree_paths(model.schema).values()) * 4
    for int8, kw in ((True, dict(wdtype="int8")),
                     (False, dict(wdtype="bf16")), (False, {})):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tree = model.init_int8(0) if int8 else model.init(
            0, dtype=torch.bfloat16, by_layer=True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        assert torch.cuda.max_memory_allocated() - before <= 4 * slice_f32 \
            + (1 << 20)
        assert before > base
        eng = ServeEngine(model, params=tree, n_slots=2, max_len=64,
                          page_size=8, device="cuda", **kw)
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated() - before
        # the pools, each rounded up to the allocator's 512-byte blocks
        assert grew <= eng.kv_cache_bytes() + 4096, \
            (grew, eng.kv_cache_bytes())
        for k, v in tree_paths(eng.params).items():
            assert v is tree_paths(tree)[k], k
        del eng, tree
