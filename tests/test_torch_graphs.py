"""The engines' static steps (`repro_torch.serve.graphs.StepGraph`) on the
CPU, where they run without capture on the same static buffers a CUDA
graph reads on the card: the step objects, the engines built on them
against their `eager=True` twins (identical tokens, bit-equal kept
logits, every family and layout, the sharded engine too), one host sync a
decode tick, the address check that stops a replay over a rebound pool,
and the capture repairs in the models (the dense decode write without a
host sync, keeping the JAX one-hot's semantics; the encoder-decoder's
chunk slot as a device index; a fixed decode depth filled on the device).
The counters against the JAX engine's are held in the per-family files
and `tests/test_torch_sanitizer.py`; the card's captures in
`tests/test_torch_kernels_cuda.py` and in this file's `cuda` cases (the
monolithic prefill and paste, the page move), which skip without a card.
JAX is imported only by the test that compares with it, so the card cases
run where PyTorch alone is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_graphs.py -m cuda"""

import numpy as np
import pytest
import torch

from repro_torch.analysis import sanitizer
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec
from repro_torch.models import transformer
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import EngineStats, ServeEngine
from repro_torch.serve.graphs import StepGraph
from repro_torch.serve.sharded import ShardedServeEngine
from repro_torch.tree import tree_leaves

# one intra-op thread a test process (xdist runs six)
torch.set_num_threads(1)

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        model = build_model(get_config(arch).smoke(), device="cpu")
        _MODELS[arch] = (model, model.init(seed=0))
    return _MODELS[arch]


def _traffic(eng, sample=True, lens=(40, 7, 70, 23, 33)):
    rng = np.random.default_rng(5)
    reqs = []
    for i, n in enumerate(lens):
        extras = None
        if eng.cfg.family == "vlm" and i % 2 == 0:
            extras = {"patch_embeds": rng.standard_normal(
                (min(n, 12), eng.cfg.d_model)).astype(np.float32)}
        if eng.cfg.family == "encdec":
            extras = {"frames": rng.standard_normal(
                (eng.cfg.cross_len, eng.cfg.d_model)).astype(np.float32)}
        reqs.append(eng.submit(
            rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=5, extras=extras, seed=i,
            sample_params=(0.8, 20, 0.9) if sample and i == 3 else None))
    return reqs


class _Owner:
    def __init__(self):
        self.stats = EngineStats()
        self.w = torch.ones(3)


def _step(owner, eager=False):
    return StepGraph(owner, lambda o, inp: (inp["x"] + o.w, inp["m"]),
                     {"x": ((3,), torch.float32), "m": ((2, 2), torch.bool)},
                     state=lambda o: [o.w], stat="chunk_compiles",
                     label="graphs_test", device="cpu", eager=eager)


@pytest.mark.parametrize("eager", [False, True])
def test_step_reads_static_buffers(eager):
    """Each call stages its values into the same input tensors (the
    addresses a graph captures), builds once, and returns the step's
    result on them."""
    owner = _Owner()
    step = _step(owner, eager)
    ptrs = {k: v.data_ptr() for k, v in step.inputs.items()}
    for i in range(3):
        x, m = step(x=np.arange(3) + i, m=np.eye(2, dtype=bool) ^ (i % 2))
        assert torch.equal(x, torch.arange(3.0) + i + 1)
        assert m.tolist() == (np.eye(2, dtype=bool) ^ (i % 2)).tolist()
    assert {k: v.data_ptr() for k, v in step.inputs.items()} == ptrs
    assert step.captures == owner.stats.chunk_compiles == 1
    assert not step.captured                 # no graph on the CPU


def test_rebound_state_raises_on_the_next_call():
    owner = _Owner()
    step = _step(owner)
    step(x=np.zeros(3), m=np.zeros((2, 2), bool))
    owner.w = owner.w.clone()
    with pytest.raises(RuntimeError, match="rebound"):
        step(x=np.zeros(3), m=np.zeros((2, 2), bool))


def test_tensor_inputs_are_copied_into_their_buffers():
    """An input given as a tensor is copied into its static buffer; a bf16
    input has a buffer of its own and no staging span, so it must come as
    a tensor."""
    owner = _Owner()
    step = StepGraph(owner, lambda o, inp: inp["x"] + inp["p"].float(),
                     {"x": ((3,), torch.float32),
                      "p": ((3,), torch.bfloat16)},
                     state=lambda o: [o.w], stat=None, label=None,
                     device="cpu", eager=False)
    assert set(step._host_np) == {"x"}
    ptrs = {k: v.data_ptr() for k, v in step.inputs.items()}
    p = torch.tensor([0.5, 1.5, 2.5], dtype=torch.bfloat16)
    assert step(x=np.ones(3), p=p).tolist() == [1.5, 2.5, 3.5]
    assert step(x=torch.full((3,), 2.0), p=p).tolist() == [2.5, 3.5, 4.5]
    assert {k: v.data_ptr() for k, v in step.inputs.items()} == ptrs
    with pytest.raises(TypeError, match="must be a tensor"):
        step(x=np.ones(3), p=np.ones(3, np.float32))


ENGINES = {
    "paged": ("smollm-360m", dict(page_size=16)),
    "paged-int8": ("smollm-360m", dict(page_size=16, wdtype="int8",
                                       kv_dtype="int8")),
    "paged-mono": ("smollm-360m", dict(page_size=16, chunked_prefill=False)),
    "dense": ("smollm-360m", dict(paged=False, chunked_prefill=False)),
    "dense-fp8": ("smollm-360m", dict(paged=False, chunked_prefill=False,
                                      kv_dtype="fp8")),
    "moe": ("qwen2-moe-a2.7b", dict(page_size=16)),
    "mla": ("deepseek-v2-lite", dict(page_size=16, kv_dtype="bf16")),
    "vlm": ("llava-next-mistral-7b", dict(page_size=16)),
    "encdec": ("seamless-m4t-medium", dict(page_size=16)),
    "encdec-dense": ("seamless-m4t-medium",
                     dict(paged=False, chunked_prefill=False)),
    "ssm": ("mamba2-780m", {}),
    "hybrid": ("recurrentgemma-2b", {}),
}


def _engine(case, eager, **over):
    arch, kw = ENGINES[case]
    model, params = _model(arch)
    return ServeEngine(model, params=params, n_slots=4, max_len=128,
                       eager=eager, device="cpu",
                       **{"keep_logits": True, **kw, **over})


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_equals_eager_twin(case):
    """The static-step engine and its `eager=True` twin: identical tokens,
    bit-equal kept logits, equal counters, within COMPILE_BUDGETS."""
    runs = []
    for eager in (False, True):
        eng = _engine(case, eager)
        with sanitizer.compile_budget(**ServeEngine.COMPILE_BUDGETS):
            reqs = _traffic(eng)
            eng.run_to_completion()
        runs.append((eng, reqs))
    (a, ra), (b, rb) = runs
    for x, y in zip(ra, rb):
        assert x.out_tokens == y.out_tokens and len(x.out_tokens) == 5
        assert len(x.logits) == len(y.logits) > 0
        assert all(torch.equal(p, q) for p, q in zip(x.logits, y.logits))
    assert a.stats.summary().keys() == b.stats.summary().keys()
    for name in ("decode_compiles", "chunk_compiles", "decode_steps",
                 "prefill_chunks"):
        assert getattr(a.stats, name) == getattr(b.stats, name), name
    assert a.stats.chunk_compiles == int(a.chunked)


@pytest.mark.parametrize("case", ["paged", "dense", "hybrid"])
def test_one_host_sync_per_decode_tick(case):
    """A tick that decodes brings back its tokens and positions in ONE host
    sync; a warm wave builds no step."""
    eng = _engine(case, False, keep_logits=False)
    _traffic(eng, sample=False)
    eng.run_to_completion()
    _traffic(eng, sample=True)
    while eng._queue or any(eng._slots):
        steps = eng.stats.decode_steps
        with sanitizer.watch() as log:
            eng.step()
        if eng.stats.decode_steps > steps and not eng._queue:
            assert log.host_syncs == 1
        assert log.compiles <= 1              # the sampled step, once


@pytest.mark.parametrize("key", ["k", "pos", "page_table"])
def test_rebound_cache_tensor_stops_the_next_tick(key):
    """Negative control: a cache tensor rebound between ticks (here a copy
    of equal content) makes the next step call raise instead of running a
    graph over the stale address."""
    eng = _engine("paged", False)
    _traffic(eng)
    for _ in range(4):
        eng.step()
    eng._cache[key] = eng._cache[key].clone()
    with pytest.raises(RuntimeError, match="rebound"):
        for _ in range(3):
            eng.step()


def test_sharded_engine_equals_eager_twin_and_guards_its_pool():
    model, params = _model("smollm-360m")
    runs = []
    for eager in (False, True):
        eng = ShardedServeEngine(model, mesh=make_serve_mesh(2, device="cpu"),
                                 n_slots=4, max_len=128, params=params,
                                 page_size=16, eager=eager)
        with sanitizer.compile_budget(
                **ShardedServeEngine.COMPILE_BUDGETS) as log:
            reqs = _traffic(eng)
            eng.run_to_completion()
        runs.append(([r.out_tokens for r in reqs], log.entry_compiles,
                     eng))
    assert runs[0][:2] == runs[1][:2]
    assert runs[0][1]["chunk"] == 1 and runs[0][1]["decode"] == 2
    eng = runs[0][2]
    _traffic(eng, sample=False)
    eng.step()
    eng._cache["k"] = eng._cache["k"].clone()
    with pytest.raises(RuntimeError, match="rebound"):
        for _ in range(3):
            eng.step()


def test_engine_state_is_written_in_place():
    """Every cache tensor keeps its address over a whole run of admissions,
    chunks, decode steps, window recycling and releases."""
    eng = _engine("paged", False)
    before = [t.data_ptr() for t in tree_leaves(eng._cache)]
    _traffic(eng)
    eng.run_to_completion()
    assert [t.data_ptr() for t in tree_leaves(eng._cache)] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e5m2, torch.int8])
def test_dense_decode_write_keeps_the_one_hot(dtype):
    import jax.numpy as jnp
    from repro.models import transformer as jtransformer
    """The sync-free dense row write (`transformer._write_cache[_q]`): a
    position inside the cache takes the row, one past it writes nothing, as
    the JAX one-hot (`repro/models/transformer.py:_write_cache`)."""
    rng = np.random.default_rng(0)
    b, smax, kv, d = 4, 6, 2, 8
    cache = rng.standard_normal((b, smax, kv, d)).astype(np.float32)
    new = rng.standard_normal((b, 1, kv, d)).astype(np.float32)
    pos = np.array([0, 5, 6, 9], np.int32)           # two past Smax
    want = np.asarray(jtransformer._write_cache(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos)))
    if dtype == torch.int8:
        qc, sc = transformer.quantize_kv_rows(torch.as_tensor(cache))
        q0, s0 = qc.clone(), sc.clone()
        transformer._write_cache_q(qc, sc, torch.as_tensor(new),
                                   torch.as_tensor(pos))
        qn, sn = transformer.quantize_kv_rows(torch.as_tensor(new))
        for i, p in enumerate(pos):
            wq, ws = (qn[i, 0], sn[i, 0]) if p < smax else (q0[i], s0[i])
            got_q, got_s = (qc[i, p], sc[i, p]) if p < smax else (qc[i], sc[i])
            assert torch.equal(got_q, wq) and torch.equal(got_s, ws)
        return
    tc = torch.as_tensor(cache).to(dtype)
    transformer._write_cache(tc, torch.as_tensor(new), torch.as_tensor(pos))
    assert torch.equal(tc, torch.from_numpy(want.copy()).to(dtype))


def test_encdec_chunk_takes_its_slot_as_a_device_index():
    """The chunk step's slot as a (1,) tensor reads the same cross rows as
    the int, so one captured chunk step serves every slot."""
    model, params = _model("seamless-m4t-medium")
    cfg = model.cfg
    rng = np.random.default_rng(1)
    outs = []
    for slot in (2, torch.tensor([2])):
        cache = transformer.alloc_cache(model.cache_shape(
            4, 64, torch.float32, page_size=16, n_pages=17), "cpu")
        for key in ("ck", "cv"):
            cache[key].copy_(torch.as_tensor(rng.standard_normal(
                cache[key].shape).astype(np.float32)))
        rng = np.random.default_rng(1)       # the same cross rows again
        batch = {"tokens": torch.arange(16, dtype=torch.int32)[None] % 50,
                 "start": torch.tensor([0], dtype=torch.int32),
                 "length": torch.tensor([11], dtype=torch.int32),
                 "page_row": torch.tensor([3, 4, 0, 0], dtype=torch.int32),
                 "slot": slot}
        encdec.prefill_chunk(params, batch, cache, cfg)
        outs.append(cache["k"].clone())
    assert torch.equal(outs[0], outs[1]) and outs[0].abs().sum() > 0


def test_decode_attention_fixed_depth_equals_its_tensor():
    rng = np.random.default_rng(2)
    q = torch.as_tensor(rng.standard_normal((3, 1, 2, 2, 16)),
                        dtype=torch.float32)
    k, v = (torch.as_tensor(rng.standard_normal((3, 20, 2, 16)),
                            dtype=torch.float32) for _ in range(2))
    a = attn_mod.decode_attention(q, k, v, 13)
    b = attn_mod.decode_attention(q, k, v, torch.full((3,), 13))
    assert torch.equal(a, b)


# ------------------------------------------------------------------ card
# monolithic prefill and the paste, captured on the card, against their
# `eager=True` twins; the page move; a rebound pool


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph captures only there")
    return torch.device("cuda")


_CARD_MODELS = {}


def _card_model(arch, dev):
    if arch not in _CARD_MODELS:
        model = build_model(get_config(arch).smoke(), device=dev)
        _CARD_MODELS[arch] = (model, model.init(seed=0))
    return _CARD_MODELS[arch]


CARD_MONO = {
    "dense-bf16kv": dict(paged=False, chunked_prefill=False,
                         kv_dtype="bf16"),
    "dense-int8kv": dict(paged=False, chunked_prefill=False,
                         kv_dtype="int8"),
    "paged-mono": dict(page_size=16, chunked_prefill=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_MONO))
def test_captured_monolithic_engine_equals_eager_twin_on_card(case):
    """Dense (bf16 and int8 KV) and paged monolithic engines whose prefill
    and paste steps are CUDA graphs: the same tokens and bit-equal kept
    logits as their `eager=True` twins, the same builds, and every built
    prefill and paste step a graph (none on the twin)."""
    dev = _card()
    model, params = _card_model("smollm-360m", dev)
    runs = []
    for eager in (False, True):
        eng = ServeEngine(model, params=params, n_slots=4, max_len=128,
                          wdtype="bf16", keep_logits=True, eager=eager,
                          device=dev, **CARD_MONO[case])
        reqs = _traffic(eng)
        eng.run_to_completion()
        runs.append((eng, reqs))
    (a, ra), (b, rb) = runs
    for x, y in zip(ra, rb):
        assert x.out_tokens == y.out_tokens and len(x.out_tokens) == 5
        assert len(x.logits) == len(y.logits) > 0
        assert all(torch.equal(p, q) for p, q in zip(x.logits, y.logits))
    for name in ("prefill_compiles", "paste_compiles", "decode_compiles"):
        assert getattr(a.stats, name) == getattr(b.stats, name) > 0, name
    assert a.steps["prefill"].captured and a.steps["paste"].captured
    assert not (b.steps["prefill"].captured or b.steps["paste"].captured)


@pytest.mark.cuda
def test_captured_move_copies_pages_byte_equal_on_card():
    """The sharded engine's move step on the card: a wave's destination
    pages hold their sources' bytes (every pool, every layer), a second
    wave replays the graph, and nothing else of the pool changes."""
    dev = _card()
    model, params = _card_model("smollm-360m", dev)
    eng = ShardedServeEngine(model, mesh=make_serve_mesh(2, device=dev),
                             n_slots=4, max_len=128, params=params,
                             page_size=16, wdtype="bf16", kv_dtype="int8")
    gen = torch.Generator(device=dev).manual_seed(0)
    for pool in eng._pools.values():
        pool.copy_(torch.randint(-100, 100, pool.shape, generator=gen,
                                 device=dev).to(pool.dtype))
    n = eng.n_pages
    for wave in ([(0, 3, 1, 5), (1, 2, 0, 7)], [(0, 4, 1, 6)]):
        before = {k: v.clone() for k, v in eng._pools.items()}
        eng._device_move(wave)
        for k, v in eng._pools.items():
            want = before[k].clone()
            for ss, sp, ds, dp in wave:
                want[:, ds * n + dp] = before[k][:, ss * n + sp]
            keep = torch.ones(v.shape[1], dtype=torch.bool, device=dev)
            keep[[s * n for s in range(eng.n_shards)]] = False
            assert torch.equal(v[:, keep], want[:, keep]), k
    assert eng.steps["move"].captured and eng.steps["move"].captures == 1


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_rebound_pool_raises_on_the_next_prefill(device):
    """A monolithic engine whose pool is rebound after its prefill and
    paste steps were built raises "rebound" at the next admission's paste
    instead of pasting into the stale address."""
    dev = _card() if device == "cuda" else torch.device("cpu")
    model, params = (_card_model("smollm-360m", dev) if device == "cuda"
                     else _model("smollm-360m"))
    eng = ServeEngine(model, params=params, n_slots=4, max_len=128,
                      paged=False, chunked_prefill=False, device=dev)
    prompt = np.arange(9, dtype=np.int32) % 50
    eng.submit(prompt, max_new_tokens=2)
    eng.run_to_completion()
    eng._cache["k"] = eng._cache["k"].clone()
    eng.submit(prompt, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="rebound"):
        eng.step()
