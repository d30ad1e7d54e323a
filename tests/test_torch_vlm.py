"""Port parity, the vlm family: llava-next-mistral-7b `.smoke()` (the
Mistral decoder, 2 query heads a KV head, patch embeddings over the
leading positions) in f32 with the JAX package's weights, bridged.

Model level: the bridged tree has the port's schema leaf for leaf; prefill
logits and K/V rows with 0 to 19 patch rows (drawn at the embedding
table's row scale), and `train_loss` with its
image positions unlabelled, equal the JAX package's (f32, atol = rtol =
1e-4: the same math in another summation order).

Engine level: a traffic of six requests, three of whose patch counts
split the smoke engines' 16-row chunk and 8-row page (5, 12, 19 patch
rows), one with the config's 8, one text-only and one whose last prompt
position is a patch row (the replay writes that row from the last token's
embedding, as every replay of the reference does). Every layout (dense,
paged monolithic, paged chunked) emits the JAX engine's tokens in the
same layout with an f32 KV pool, and the JAX chunked engine's with bf16
and int8 pools and with int8 weights. The reference's own vlm cases
(`test_chunked_families_exact`/`_kv_matrix`,
`test_paged_families_match_oracle`, `test_int8_engine_families_exact`)
run on the port against its `generate_greedy`. The prefix cache shares
pages between two requests with one image and a shared text prefix, and
none between equal tokens under two images, with the JAX engine's
counters and tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model as jbuild
from repro.serve.engine import ServeEngine as JaxEngine

from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine, generate_greedy
from repro_torch.tree import tree_paths

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

ARCH = "llava-next-mistral-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN, PAGE, SLOTS, NEW = 64, 8, 3, 4
LAYOUTS = {"dense": dict(paged=False, chunked_prefill=False),
           "paged": dict(paged=True, page_size=PAGE, chunked_prefill=False),
           "chunked": dict(paged=True, page_size=PAGE, chunked_prefill=True)}
COUNTERS = ("prefills", "prefill_tokens", "prefill_pad_tokens",
            "prefill_chunks", "decode_steps", "tokens_out",
            "peak_pages_in_use", "pages_in_use", "decode_compiles",
            "chunk_compiles")
# (prompt length, patch rows): chunk 16 and page 8 split by 5, 12 and 19
# patch rows; the config's 8; text only; a prompt of patch rows only
TRAFFIC = [(17, 8), (24, 12), (30, 19), (20, 0), (12, 12), (26, 5)]


@pytest.fixture(scope="module")
def case():
    cfg = get_config(ARCH).smoke()
    jm = jbuild(cfg)                     # default ExecOptions: chunked
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, jp, build_model(cfg, device="cpu"), tp


# patch rows at the embedding table's row scale (its schema std): a
# projector maps the image into the embedding space
PATCH_STD = 0.02


def _patches(seed, n, d):
    return (PATCH_STD * np.random.default_rng(seed).standard_normal((n, d))
            ).astype(np.float32)


def _traffic(cfg):
    """[(prompt, extras)]: an image of its own per request."""
    rng = np.random.default_rng(5)
    out = []
    for i, (n, p) in enumerate(TRAFFIC):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        out.append((prompt, {"patch_embeds": _patches(100 + i, p,
                                                      cfg.d_model)}
                    if p else None))
    return out


def _serve(eng, traffic):
    reqs = [eng.submit(p, max_new_tokens=NEW, extras=x) for p, x in traffic]
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def jax_tokens(case):
    """(layout, kv_dtype, wdtype) → the JAX engine's tokens of the
    traffic, each engine run once a module."""
    cfg, jm, jp, _, _ = case
    done = {}

    def run(layout, kv=None, wdtype=None):
        key = (layout, kv, wdtype)
        if key not in done:
            eng = JaxEngine(jm, params=jp, n_slots=SLOTS, max_len=MAX_LEN,
                            prefix_cache=False, kv_dtype=kv, wdtype=wdtype,
                            **LAYOUTS[layout])
            done[key] = (_serve(eng, _traffic(cfg)), eng.stats)
        return done[key]
    return run


def test_bridge_carries_the_vlm_tree(case):
    """The JAX tree, bridged, has the port's schema: every leaf's path,
    shape and dtype equal the port's own init."""
    cfg, _, _, tm, tp = case
    mine = tree_paths(tm.init(seed=0, dtype=torch.float32))
    got = tree_paths(tp)
    assert sorted(got) == sorted(mine)
    for path, leaf in mine.items():
        assert got[path].shape == leaf.shape and got[path].dtype == leaf.dtype


@pytest.mark.parametrize("n_patch", [0, 5, 8, 12, 19])
def test_prefill_logits_and_rows_with_patches(case, n_patch):
    cfg, jm, jp, tm, tp = case
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)
                                             ).astype(np.int32)
    batch = {"tokens": toks}
    if n_patch:
        batch["patch_embeds"] = np.stack(
            [_patches(s, n_patch, cfg.d_model) for s in (2, 3)])
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = tm.prefill(tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)


def test_int8_tree_matches_jax(case):
    """`quantize_params` quantizes the leaves the JAX package's does
    (layers), bit for bit, and `ModelApi.init_int8` equals it on the
    by-layer float draw."""
    from repro.models import quantized as jq
    from repro_torch.models import quantized as tq
    cfg, _, jp, tm, tp = case
    want = tree_paths(jax.tree.map(np.asarray, jq.quantize_params(jp, cfg)))
    got = tree_paths(tq.quantize_params(tp, cfg))
    assert sorted(got) == sorted(want)
    assert {p.split("/")[0] for p in got if p.endswith("int8_q")} == {"layers"}
    for path, leaf in want.items():
        assert got[path].numpy().tobytes() == leaf.tobytes(), path
    drawn = tree_paths(tm.init_int8(seed=3))
    direct = tree_paths(tq.quantize_params(tm.init(seed=3, by_layer=True), cfg))
    assert sorted(drawn) == sorted(direct)
    for path, leaf in direct.items():
        assert torch.equal(drawn[path], leaf), path


def test_train_loss_masks_image_positions(case):
    cfg, jm, jp, tm, tp = case
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "patch_embeds": np.stack([_patches(s, 8, cfg.d_model)
                                       for s in (6, 7)])}
    jl, _ = jm.train_loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = tm.train_loss(tp, {k: torch.as_tensor(v)
                               for k, v in batch.items()}, ce_chunk=32)
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    # the image positions carry no label: changing their labels changes
    # nothing
    batch["labels"][:, :8] = 0
    tl2, _ = tm.train_loss(tp, {k: torch.as_tensor(v)
                                for k, v in batch.items()}, ce_chunk=32)
    assert tl2.item() == tl.item()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_matches_jax_engine(case, jax_tokens, layout):
    """f32 KV: the port's engine emits the JAX engine's tokens in the same
    layout, with its counters."""
    cfg, _, _, tm, tp = case
    want, jstats = jax_tokens(layout)
    eng = ServeEngine(tm, params=tp, device="cpu", n_slots=SLOTS,
                      max_len=MAX_LEN, prefix_cache=False, **LAYOUTS[layout])
    assert _serve(eng, _traffic(cfg)) == want
    for name in COUNTERS:
        assert getattr(eng.stats, name) == getattr(jstats, name), name
    if eng.paged:
        eng.assert_accounting()
        assert eng.pages_allocatable() == eng.n_pages - 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kv,wdtype", [("bf16", None), ("int8", None),
                                       ("int8", "int8")])
def test_lossy_layouts_match_jax_engine(case, jax_tokens, layout, kv, wdtype):
    """bf16 and int8 KV pools, and int8 weights: every layout emits the
    JAX chunked engine's tokens (the reference's layouts agree with one
    another token for token)."""
    cfg, _, _, tm, tp = case
    want, _ = jax_tokens("chunked", kv, wdtype)
    eng = ServeEngine(tm, params=tp, device="cpu", n_slots=SLOTS,
                      max_len=MAX_LEN, prefix_cache=False, kv_dtype=kv,
                      wdtype=wdtype, **LAYOUTS[layout])
    assert _serve(eng, _traffic(cfg)) == want
    assert eng.stats.pages_in_use == 0


def _prompt(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@pytest.mark.parametrize("name,kw,lengths,quant", [
    # test_chunked_prefill.py::test_chunked_families_exact / _kv_matrix
    ("chunked_exact", {}, (9, 17), {}),
    ("chunked_kv_bf16", {}, (17,), dict(kv_dtype="bf16")),
    ("chunked_kv_int8", {}, (17,), dict(kv_dtype="int8")),
    # test_int8_decode.py::test_int8_engine_families_exact
    ("int8_exact", {}, (7, 9), dict(wdtype="int8", kv_dtype="int8")),
])
def test_reference_family_cases(case, name, kw, lengths, quant):
    """The reference's vlm cases on the port: the chunked (or int8) paged
    engine with the config's patch rows (8: prompt 7 has fewer positions,
    so it goes text only) equals `generate_greedy` (the dense oracle, int8
    where the engine is)."""
    cfg, _, _, tm, tp = case
    pe = {"patch_embeds": _patches(8, cfg.n_image_tokens, cfg.d_model)}
    extras = {n: pe if n >= cfg.n_image_tokens else None for n in lengths}
    solo = {n: generate_greedy(tm, tp, _prompt(n, n), 3, max_len=MAX_LEN,
                               extras=extras[n], **quant) for n in lengths}
    eng = ServeEngine(tm, params=tp, device="cpu", n_slots=2,
                      max_len=MAX_LEN, page_size=PAGE, **quant, **kw)
    assert eng.chunked
    reqs = {n: eng.submit(_prompt(n, n), max_new_tokens=3, extras=extras[n])
            for n in lengths}
    eng.run_to_completion()
    for n, r in reqs.items():
        assert r.out_tokens == solo[n], (name, n, r.out_tokens, solo[n])
    assert eng.stats.pages_in_use == 0


def test_reference_paged_family_matches_oracle(case):
    """test_paged_kv.py::test_paged_families_match_oracle (vlm): text-only
    prompts through the paged pool equal the dense oracle."""
    cfg, _, _, tm, tp = case
    solo = {n: generate_greedy(tm, tp, _prompt(n, n), 3, max_len=MAX_LEN)
            for n in (7, 9)}
    eng = ServeEngine(tm, params=tp, device="cpu", n_slots=2,
                      max_len=MAX_LEN, page_size=PAGE)
    reqs = {n: eng.submit(_prompt(n, n), max_new_tokens=3) for n in (7, 9)}
    eng.run_to_completion()
    for n, r in reqs.items():
        assert r.out_tokens == solo[n], (n, r.out_tokens, solo[n])


def test_prompt_ending_in_a_patch_row_replays_as_the_reference(case,
                                                               jax_tokens):
    """A prompt of 12 positions under 12 patch rows: the replay of its last
    token writes row 11 from that token's embedding (the reference's
    replay) in every layout, and the streams equal the JAX engine's."""
    cfg, _, _, tm, tp = case
    i = TRAFFIC.index((12, 12))
    prompt, extras = _traffic(cfg)[i]
    for layout in LAYOUTS:
        eng = ServeEngine(tm, params=tp, device="cpu", n_slots=1,
                          max_len=MAX_LEN, prefix_cache=False,
                          **LAYOUTS[layout])
        r = eng.submit(prompt, max_new_tokens=NEW, extras=extras)
        eng.step()              # admits (chunked: its one chunk), replays
        assert eng._replay_writes[0], layout
        eng.run_to_completion()
        assert r.out_tokens == jax_tokens(layout)[0][i], layout


def _prefix_traffic(cfg):
    """Image X under a 12-token text prefix, then: X with the same 20
    positions and another tail (shares pages 0-2), X again with another
    text from position 13 (shares page 0 only), image Y with A's tokens,
    and A's tokens with no image (share nothing)."""
    x = _patches(20, 8, cfg.d_model)
    y = _patches(21, 8, cfg.d_model)
    a = _prompt(30, 33)
    b = np.concatenate([a[:24], _prompt(31, 9)])
    c = np.concatenate([a[:13], _prompt(32, 20)])
    return [(a, {"patch_embeds": x}), (b, {"patch_embeds": x}),
            (c, {"patch_embeds": x}), (a, {"patch_embeds": y}), (a, None)]


PREFIX_COUNTERS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
                   "cow_copies", "prefill_chunks", "peak_pages_in_use")


def test_prefix_cache_keys_pages_by_image(case):
    """One request at a time on a prefix-caching chunked engine: the second
    request (same image, 24 equal positions) maps 3 cached pages, the third
    (same image, 13) 1, the fourth (another image, equal tokens) and the
    fifth (no image) none. Counters and tokens equal the JAX engine's, and
    tokens the cache-off twin's."""
    cfg, jm, jp, tm, tp = case
    kw = dict(n_slots=1, max_len=MAX_LEN, page_size=PAGE)
    traffic = _prefix_traffic(cfg)
    engines = {"jax": JaxEngine(jm, params=jp, prefix_cache=True, **kw),
               "on": ServeEngine(tm, params=tp, device="cpu",
                                 prefix_cache=True, **kw),
               "off": ServeEngine(tm, params=tp, device="cpu",
                                  prefix_cache=False, **kw)}
    tokens, hits = {}, {}
    for name, eng in engines.items():
        tokens[name], hits[name] = [], []
        for prompt, extras in traffic:
            before = eng.stats.prefix_hit_tokens
            r = eng.submit(prompt, max_new_tokens=NEW, extras=extras)
            eng.run_to_completion()
            tokens[name].append(r.out_tokens)
            hits[name].append(eng.stats.prefix_hit_tokens - before)
    assert hits["on"] == hits["jax"] == [0, 24, 8, 0, 0]
    assert tokens["on"] == tokens["jax"] == tokens["off"]
    for name in PREFIX_COUNTERS:
        assert getattr(engines["on"].stats, name) == \
            getattr(engines["jax"].stats, name), name
    engines["on"].assert_accounting()


@pytest.mark.parametrize("extras,match", [
    ({"frames": np.zeros((4, 128), np.float32)}, "takes"),
    ({"patch_embeds": np.zeros((4, 64), np.float32)}, "patch_embeds"),
    ({"patch_embeds": np.zeros((9, 128), np.float32)}, "patch_embeds"),
])
def test_submit_refuses_malformed_extras(case, extras, match):
    cfg, _, _, tm, tp = case
    eng = ServeEngine(tm, params=tp, device="cpu", n_slots=1,
                      max_len=MAX_LEN, page_size=PAGE)
    with pytest.raises(ValueError, match=match):
        eng.submit(np.zeros((8,), np.int32), extras=extras)
