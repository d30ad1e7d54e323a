"""Port parity, the sharded engine's host side: `repro_torch.serve.
scheduler.ShardScheduler` against the JAX package's, driven by the same
seeded sequences of operations (submit, admit, chunk advance with prefix
registration, decode progress and window recycling, release, page squeezes
and restores, drain / reset / requeue, migration targets and slot moves,
prefix-page replication, preemption, placement masks), with their whole
state compared after every operation and `assert_accounting` run on both;
the migration planners and cost model (`serve/migration.py`) against the
reference's on the same states; and `models.transformer.gather_pool_pages`
/ `set_pool_page` bit-equal to the JAX package's on f32, bf16, int8 (with
f16 scales) and MLA latent pools. Host-only numpy and small pools: no
tolerance, every comparison is exact."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.serve import migration as jmigration
from repro.serve.engine import Request as JRequest
from repro.serve.scheduler import ShardScheduler as JSched

from repro_torch.models import transformer as ttransformer
from repro_torch.serve import migration as tmigration
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import request_seed_digest
from repro_torch.serve.scheduler import ShardScheduler as TSched

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

PAGE, MAX_LEN = 8, 64
# (n_shards, slots_per_shard, n_pages, window, prefix_cache)
GEOMETRIES = {
    "prefix": (4, 2, 12, 0, True),
    "tight": (3, 2, 7, 0, True),
    "window16": (4, 2, 10, 16, False),
    "nocache": (2, 3, 14, 0, False),
}


def _kw(geo):
    n_shards, sps, n_pages, window, cache = GEOMETRIES[geo]
    chunk = PAGE if window else 2 * PAGE
    return dict(n_shards=n_shards, slots_per_shard=sps, n_pages=n_pages,
                page_size=PAGE, pages_per_seq=MAX_LEN // PAGE,
                max_len=MAX_LEN, chunk_tokens=chunk, window=window,
                prefix_cache=cache)


def _rid(r):
    return None if r is None else r.rid


def _same(j, t):
    """Every field of the two schedulers' state is equal."""
    assert [r.rid for r in j.queue] == [r.rid for r in t.queue]
    for i, (js, ts) in enumerate(zip(j.shards, t.shards)):
        assert js.free_pages == ts.free_pages, i
        assert [_rid(r) for r in js.slots] == [_rid(r) for r in ts.slots], i
        assert js.prefill_fifo == ts.prefill_fifo, i
        assert js.chunk_next == ts.chunk_next, i
        assert js.slot_pages == ts.slot_pages, i
        assert js.slot_cap == ts.slot_cap, i
        assert js.pages_in_use == ts.pages_in_use, i
        assert np.array_equal(js.ref, ts.ref), i
        assert js.page_hash == ts.page_hash, i
        assert js.by_hash == ts.by_hash, i
        assert list(js.lru) == list(ts.lru), i
    assert j.stolen == t.stolen and j.placeable == t.placeable
    for name in ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
                 "prefix_evictions", "cow_copies", "digest_hits",
                 "pending_digest", "pending_by_rid", "pages_in_use"):
        assert getattr(j, name) == getattr(t, name), name
    j.assert_accounting()
    t.assert_accounting()
    t.assert_local()


class Twins:
    """The reference's scheduler and the port's, fed the same operations;
    requests are twins with one rid."""

    def __init__(self, geo, seed):
        self.j, self.t = JSched(**_kw(geo)), TSched(**_kw(geo))
        self.rng = np.random.default_rng(seed)
        self.reqs = {}
        self.rid = 0
        # a few shared prefixes so the registries hit, clone and replicate
        self.prefixes = [self.rng.integers(0, 64, 3 * PAGE).astype(np.int32)
                         for _ in range(3)]

    def submit(self):
        rng = self.rng
        if rng.random() < 0.25:
            # whole cached pages: a full hit with a copy-on-write tail
            base = self.prefixes[rng.integers(len(self.prefixes))]
            prompt = base[:PAGE * int(rng.integers(1, 4))].copy()
        elif rng.random() < 0.6:
            base = self.prefixes[rng.integers(len(self.prefixes))]
            cut = int(rng.integers(1, base.shape[0] + 1))
            tail = rng.integers(0, 64, int(rng.integers(0, 12)))
            prompt = np.concatenate([base[:cut], tail]).astype(np.int32)
        else:
            prompt = rng.integers(0, 64, int(rng.integers(1, 30))).astype(
                np.int32)
        extras = None
        if rng.random() < 0.15:
            extras = {"patch_embeds": np.full((1, 4), float(rng.integers(2)),
                                              np.float32)}
        new = int(rng.integers(1, 12))
        self.rid += 1
        jr = JRequest(rid=self.rid, prompt=prompt, max_new_tokens=new,
                      extras=extras)
        tr = TRequest(rid=self.rid, prompt=prompt, max_new_tokens=new,
                      extras=extras, seed_digest=request_seed_digest(extras))
        self.reqs[self.rid] = (jr, tr)
        self.j.queue.append(jr)
        self.t.queue.append(tr)

    def live(self):
        return [(i, slot) for i, s in enumerate(self.t.shards)
                for slot, r in enumerate(s.slots) if r is not None]

    def pick_live(self):
        live = self.live()
        return None if not live else live[self.rng.integers(len(live))]


def _placements(ps):
    return [(p.shard, p.slot, p.req.rid, p.cached_tokens, p.cow, p.full_hit)
            for p in ps]


def _work(ws):
    return [(w.shard, w.slot, w.req.rid, w.start, w.length, w.final)
            for w in ws]


def _planners(tw):
    """The three migration planners agree on this state."""
    j, t, rng = tw.j, tw.t, tw.rng
    mask = [bool(x) for x in rng.random(len(t.shards)) < 0.8]
    salt = int(rng.integers(3))

    def movable(shard, slot):
        return (shard + slot + salt) % 3 != 0

    for thr in (0, 1, 2):
        assert jmigration.plan_rebalance(j, thr, mask, movable) \
            == tmigration.plan_rebalance(t, thr, mask, movable)
    need = int(rng.integers(1, 6))
    assert jmigration.plan_starvation_rescue(j, need, mask, movable) \
        == tmigration.plan_starvation_rescue(t, need, mask, movable)
    if t.queue:
        cfg_j = jmigration.MigrationConfig(min_prefix_hits=1)
        cfg_t = tmigration.MigrationConfig(min_prefix_hits=1)
        assert jmigration.plan_prefix_replication(j, j.queue[0], cfg_j, mask) \
            == tmigration.plan_prefix_replication(t, t.queue[0], cfg_t, mask)


def _step(tw, op):
    j, t, rng = tw.j, tw.t, tw.rng
    if op == "submit":
        tw.submit()
    elif op == "admit":
        assert _placements(j.admit()) == _placements(t.admit())
    elif op == "chunk":
        jw, tws = j.next_chunks(), t.next_chunks()
        assert _work(jw) == _work(tws)
        for a, b in zip(jw, tws):
            j.advance_chunk(a)
            t.advance_chunk(b)
            if a.final:
                j.register_prefix(a.shard, a.slot, a.req)
                t.register_prefix(b.shard, b.slot, b.req)
    elif op == "decode":
        # decoding slots emit a token; window engines recycle behind it
        for i, slot in tw.live():
            if slot in t.shards[i].prefill_fifo or rng.random() < 0.3:
                continue
            tr = t.shards[i].slots[slot]
            jr = tw.reqs[tr.rid][0]
            tok = int(rng.integers(0, 64))
            jr.out_tokens.append(tok)
            tr.out_tokens.append(tok)
            if t.window:
                progress = tr.prompt.shape[0] + len(tr.out_tokens) - 1
                assert j.recycle(i, slot, progress) \
                    == t.recycle(i, slot, progress)
    elif op == "release":
        at = tw.pick_live()
        if at is not None:
            j.release(*at)
            t.release(*at)
    elif op == "squeeze":
        shard = int(rng.integers(len(t.shards)))
        if rng.random() < 0.5:
            n = int(rng.integers(1, 5))
            assert j.steal_pages(shard, n) == t.steal_pages(shard, n)
        else:
            assert j.restore_pages(shard) == t.restore_pages(shard)
    elif op == "drain":
        shard = int(rng.integers(len(t.shards)))
        jd, td = j.drain_shard(shard), t.drain_shard(shard)
        assert [r.rid for r in jd] == [r.rid for r in td]
        if rng.random() < 0.5:
            j.reset_shard(shard)
            t.reset_shard(shard)
        j.requeue(jd)
        t.requeue(td)
    elif op == "migrate":
        at = tw.pick_live()
        if at is not None:
            mask = [bool(x) for x in rng.random(len(t.shards)) < 0.8]
            dst = j.migration_target(*at, mask)
            assert dst == t.migration_target(*at, mask)
            if dst is not None:
                assert j.migrate_slot(*at, dst) == t.migrate_slot(*at, dst)
    elif op == "replicate":
        homes = [i for i, s in enumerate(t.shards) if s.by_hash]
        if homes:
            src = homes[rng.integers(len(homes))]
            digs = list(t.shards[src].by_hash)
            d = digs[rng.integers(len(digs))]
            dst = int(rng.integers(len(t.shards)))
            if dst != src:
                assert j.replicate_page(src, dst, d) \
                    == t.replicate_page(src, dst, d)
    elif op == "preempt":
        if t.queue:
            head = t.queue[0]
            need = t.pages_for(head.live_prompt().shape[0],
                               head.remaining_new())
            assert j.page_starved(need) == t.page_starved(need)
            cand = j.preempt_candidate(need, head.rid, 3)
            assert cand == t.preempt_candidate(need, head.rid, 3)
            if cand is not None:
                jr, tr = j.shards[cand[0]].slots[cand[1]], \
                    t.shards[cand[0]].slots[cand[1]]
                j.release(*cand)
                t.release(*cand)
                jr.preemptions += 1
                tr.preemptions += 1
                j.requeue([jr])
                t.requeue([tr])
    elif op == "mask":
        mask = [bool(x) for x in rng.random(len(t.shards)) < 0.75]
        j.placeable, t.placeable = list(mask), list(mask)
    elif op == "plan":
        _planners(tw)


OPS = ("submit", "submit", "admit", "admit", "chunk", "chunk", "chunk",
       "decode", "decode", "release", "squeeze", "drain", "migrate",
       "migrate", "replicate", "preempt", "mask", "plan")


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_matches_reference_step_by_step(geo, seed):
    """300 seeded operations; the whole state equal after every one."""
    tw = Twins(geo, seed)
    for _ in range(300):
        op = OPS[tw.rng.integers(len(OPS))]
        _step(tw, op)
        _same(tw.j, tw.t)
    assert tw.rid > 20
    if geo == "prefix":       # the registry hits, clones and evicts
        assert tw.t.prefix_hits and tw.t.cow_copies and tw.t.prefix_evictions


def test_scheduler_serves_a_queue_out():
    """Admit, chunk and release until the queue is empty: placements
    stay FIFO and least-loaded, and every pool returns whole."""
    tw = Twins("prefix", 5)
    for _ in range(12):
        tw.submit()
    for _ in range(200):
        for op in ("admit", "chunk", "decode"):
            _step(tw, op)
        for i, slot in tw.live():
            if slot not in tw.t.shards[i].prefill_fifo:
                tw.j.release(i, slot)
                tw.t.release(i, slot)
        _same(tw.j, tw.t)
        if not tw.t.queue and not tw.live():
            break
    assert not tw.t.queue and not tw.live()
    for s in tw.t.shards:
        assert s.pages_in_use == 0 and s.allocatable() == tw.t.n_pages - 1


# ----------------------------------------------------------- cost model
def _pools(kind, n_pages=6, layers=2, ps=4):
    """(numpy pools) of one cache format: f32, bf16, int8 with f16 scales,
    or MLA's single latent pool."""
    rng = np.random.default_rng(11)
    if kind == "mla":
        return {"k": rng.standard_normal(
            (layers, n_pages, ps, 1, 24)).astype(np.float32)}
    shape = (layers, n_pages, ps, 2, 8)
    if kind == "int8":
        pools = {}
        for key in ("k", "v"):
            pools[key] = rng.integers(-127, 128, shape).astype(np.int8)
            pools[key + "s"] = rng.random(shape[:-1]).astype(np.float16)
        return pools
    dt = ml_dtypes.bfloat16 if kind == "bf16" else np.float32
    return {key: rng.standard_normal(shape).astype(dt) for key in ("k", "v")}


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _bytes(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.uint8).numpy().tobytes() if x.dtype in (
            torch.bfloat16, torch.float16) else x.numpy().tobytes()
    return np.asarray(x).tobytes()


KINDS = ("f32", "bf16", "int8", "mla")


@pytest.mark.parametrize("kind", KINDS)
def test_page_payload_bytes_matches_reference(kind):
    pools = _pools(kind)
    want = jmigration.page_payload_bytes(
        {k: jnp.asarray(v) for k, v in pools.items()})
    assert tmigration.page_payload_bytes(
        {k: _torch(v) for k, v in pools.items()}) == want


@pytest.mark.parametrize("payload", [1.0, 4096.0, 98304.0, 262144.0,
                                     7.5e6])
@pytest.mark.parametrize("tick_us", [1000.0, 50.0])
def test_migration_cost_matches_reference(payload, tick_us):
    """Hold ticks and wire bytes through `core/ucie.transfer`, as the
    reference's."""
    want = jmigration.migration_cost(
        payload, jmigration.MigrationConfig(tick_us=tick_us))
    got = tmigration.migration_cost(
        payload, tmigration.MigrationConfig(tick_us=tick_us))
    assert got == want and got[0] >= 1


# --------------------------------------------------------- device move
@pytest.mark.parametrize("kind", KINDS)
def test_gather_and_set_pool_pages_bit_equal(kind):
    """The outbox of pages (3, 0, 5, 3) and each page written into a
    destination, the last one a page exported in the same wave, as JAX's
    `gather_pool_pages` / `set_pool_page`; the port's vector write of a
    wave equals the writes one page at a time."""
    pools = _pools(kind)
    jc = {k: jnp.asarray(v) for k, v in pools.items()}
    tc = {k: _torch(v) for k, v in pools.items()}
    ids = [3, 0, 5, 3]
    jout = jtransformer.gather_pool_pages(jc, jnp.asarray(ids, jnp.int32))
    tout = ttransformer.gather_pool_pages(tc, torch.tensor(ids))
    assert set(jout) == set(tout) == set(pools)
    for k in pools:
        assert tuple(tout[k].shape) == tuple(jout[k].shape)
        assert _bytes(tout[k]) == _bytes(jout[k]), k
    dsts = [1, 2, 4, 5]
    for m, dst in enumerate(dsts):
        jc = jtransformer.set_pool_page(
            jc, dst, {k: v[:, m] for k, v in jout.items()})
        ttransformer.set_pool_page(tc, dst,
                                   {k: v[:, m] for k, v in tout.items()})
    for k in pools:
        assert _bytes(tc[k]) == _bytes(jc[k]), k
    wave = {k: _torch(v) for k, v in pools.items()}
    out = ttransformer.gather_pool_pages(wave, torch.tensor(ids))
    ttransformer.set_pool_page(wave, torch.tensor(dsts), out)
    for k in pools:
        assert _bytes(wave[k]) == _bytes(tc[k]), k
