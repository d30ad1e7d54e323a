"""Port parity, live page migration: the port's `ShardedServeEngine`
against the JAX package's on the cases of `tests/test_migration.py` that
move a slot by hand: mid-decode migration on dense, moe (qwen2-moe) and
MLA (deepseek-v2-lite) `.smoke()` with f32 and int8 pools and int8
weights, and a slot that shares registered prefix pages moving away; and
the cost model's one call path (`core/ucie.transfer`).

The reference's sharded engine needs a device per shard, so its side runs
once a module in a subprocess with
XLA_FLAGS=--xla_force_host_platform_device_count=8 (the reference tests'
idiom), which runs this file's scenarios with the JAX package and prints
their tokens and counters as JSON. The port runs the same scenario code
in process, on the same weights (bridged from the JAX init) and prompts,
and must give the same tokens and the same counters: migrations, migrated
pages and wire bytes, recoveries and their ticks, preemptions, retries,
rebalance events, prefill chunks, decode steps, prefix hits, COW copies,
and `shard_summary()`. The scenarios keep the reference tests' own gates:
a migrated stream equals its stay-put twin, with exact pool accounting
after every move.

`tests/test_torch_sharded_chaos.py` and `tests/test_torch_sharded.py`
run their scenarios through this file's harness (`Api`, `JaxResults`,
`run_scenarios`, `assert_same`)."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARK = "SCENARIO_RESULTS "
COUNTERS = ("migrations", "migrated_pages", "migrated_bytes_compressed",
            "recoveries", "recovery_ticks_sum", "preemptions", "retries",
            "rebalance_events", "prefill_chunks", "decode_steps",
            "prefix_hits", "cow_copies", "faults_injected", "prefills",
            "tokens_out", "timeouts", "peak_pages_in_use", "pages_in_use")


class Api:
    """One package's sharded-serving entry points, so that one scenario
    function runs under either: "jax" (the reference, on a forced 8-device
    CPU mesh) or "torch" (the port on the CPU, weights bridged from the JAX
    init). Models are built once per (arch, key, window)."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self._built = {}
        if pkg == "jax":
            from repro.serve import faults
            from repro.serve.sharded import ShardedServeEngine
        else:
            from repro_torch.serve import faults
            from repro_torch.serve.sharded import ShardedServeEngine
        self.faults = faults
        self.Engine = ShardedServeEngine

    def build(self, arch, key=1, window=None):
        if (arch, key, window) not in self._built:
            from repro.configs import get_config
            from repro.models import ExecOptions, build_model as jbuild
            cfg = get_config(arch).smoke()
            if window is not None:
                cfg = dataclasses.replace(cfg, window=window)
            jm = jbuild(cfg, ExecOptions(attn_impl="reference", ce_chunk=32))
            jp = jm.init(jax.random.key(key))
            if self.pkg == "jax":
                built = (jm, jp)
            else:
                from repro_torch.bridge import params_from_numpy
                from repro_torch.models.registry import build_model
                built = (build_model(cfg, device="cpu"),
                         params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu"))
            self._built[(arch, key, window)] = built
        return self._built[(arch, key, window)]

    def mesh(self, n):
        if self.pkg == "jax":
            from repro.launch.mesh import make_serve_mesh
            return make_serve_mesh(n)
        from repro_torch.launch.mesh import make_serve_mesh
        return make_serve_mesh(n, device="cpu")

    def engine(self, arch, n_shards, key=1, window=None, **kw):
        model, params = self.build(arch, key, window)
        return self.Engine(model, mesh=self.mesh(n_shards), params=params,
                           **kw)

    def plan(self, *events):
        """A FaultPlan of (tick, kind, shard, extra fields) tuples."""
        F = self.faults
        return F.FaultPlan(events=tuple(
            F.FaultEvent(tick=t, kind=k, shard=s, **x)
            for t, k, s, x in events))


def prompt(seed, n, vocab=512):
    """The reference tests' prompts."""
    return np.asarray(jax.random.randint(
        jax.random.key(seed), (n,), 0, vocab), np.int32)


def summary(eng, reqs, **extra):
    """What a scenario reports: tokens, counters, the shard summary."""
    st = eng.stats
    out = {"tokens": [list(map(int, r.out_tokens)) for r in reqs],
           "counters": {k: getattr(st, k) for k in COUNTERS},
           "shard_summary": eng.shard_summary()}
    out.update(extra)
    return out


def run_scenarios(api, scenarios):
    """{name: result} of every scenario under one package."""
    return {name: fn(api) for name, fn in scenarios.items()}


def jax_main(module_file):
    """The subprocess body: the scenarios of `module_file` under the
    reference, as one JSON line."""
    spec = importlib.util.spec_from_file_location("scenarios", module_file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = run_scenarios(Api("jax"), mod.SCENARIOS)
    print(MARK + json.dumps(res), flush=True)


class JaxResults:
    """`jax_main` of a module on a forced 8-device CPU mesh, in a
    subprocess started at once; `get()` waits for its JSON. The port's
    side runs in the meantime."""

    def __init__(self, module_file):
        env = {**os.environ, "PYTHONPATH": "src",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "JAX_PLATFORMS": "cpu"}
        code = ("import sys; sys.path.insert(0, 'tests'); "
                "import test_torch_migration as h; "
                f"h.jax_main({module_file!r})")
        # files, not pipes: nothing reads the child's output until `get`
        self._out, self._err = tempfile.TemporaryFile(), \
            tempfile.TemporaryFile()
        self._proc = subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=REPO,
            stdout=self._out, stderr=self._err)
        self._res = None

    def get(self):
        if self._res is None:
            self._proc.wait(timeout=900)
            out, err = (f.seek(0) or f.read().decode() for f in
                        (self._out, self._err))
            assert self._proc.returncode == 0, (out[-2000:], err[-4000:])
            line = next(x for x in out.splitlines() if x.startswith(MARK))
            self._res = json.loads(line[len(MARK):])
        return self._res

    def close(self):
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._out.close()
        self._err.close()


def assert_same(got, want, name):
    """Tokens, counters and shard summary equal the reference's."""
    assert got["tokens"] == want["tokens"], name
    for k in COUNTERS:
        assert got["counters"][k] == want["counters"][k], (name, k)
    assert got["shard_summary"] == want["shard_summary"], name
    for k in set(want) - {"tokens", "counters", "shard_summary"}:
        assert got[k] == want[k], (name, k)


# ---------------------------------------------------------------- scenarios
def run_traffic(eng, lens, max_new=4, migrate_after=None):
    """The reference's `run_traffic`: optional mid-decode migration of the
    first active slot after `migrate_after` ticks, with exact accounting
    on both shards right after the move. Returns (requests, moved)."""
    reqs = [eng.submit(prompt(i, n), max_new_tokens=max_new, seed=100 + i)
            for i, n in enumerate(lens)]
    moved = ticks = 0
    while (eng._sched.queue or any(r is not None for r in eng._slots)) \
            and ticks < 400:
        eng.step()
        ticks += 1
        if migrate_after is not None and ticks >= migrate_after \
                and moved == 0:
            for g in [g for g in range(eng.n_slots) if eng._active[g]]:
                shard, slot = divmod(g, eng.slots_per_shard)
                dst = eng._sched.migration_target(shard, slot)
                if dst is not None:
                    eng._migrate_slot(shard, slot, dst)
                    eng.assert_pool_accounting()
                    eng.assert_local_page_tables()
                    moved += 1
                    break
    assert all(r.done for r in reqs)
    eng.assert_pool_accounting()
    return reqs, moved


EXACTNESS = {
    "dense_f32": ("smollm-360m", {}, [9, 17, 6], 4),
    "dense_int8": ("smollm-360m", {"wdtype": "int8", "kv_dtype": "int8"},
                   [9, 17, 6], 4),
    "moe_f32": ("qwen2-moe-a2.7b", {}, [9, 17, 6], 4),
    "moe_int8": ("qwen2-moe-a2.7b", {"wdtype": "int8", "kv_dtype": "int8"},
                 [9, 17, 6], 4),
    "mla_f32": ("deepseek-v2-lite", {}, [9, 17], 3),
    "mla_int8": ("deepseek-v2-lite", {"wdtype": "int8", "kv_dtype": "int8"},
                 [9, 17], 3),
}


def _exactness(case):
    def run(api):
        arch, kw, lens, new = EXACTNESS[case]
        eng = api.engine(arch, 4, n_slots=8, max_len=64, page_size=8, **kw)
        reqs, moved = run_traffic(eng, lens, max_new=new, migrate_after=2)
        return summary(eng, reqs, moved=moved)
    return run


def shared_cow(api):
    """One of two slots sharing a registered prefix moves to another
    shard; the sharer stays on the originals."""
    eng = api.engine("smollm-360m", 4, n_slots=8, max_len=64, page_size=8)
    sysp = prompt(0, 16)
    r0 = eng.submit(sysp.copy(), max_new_tokens=2)
    eng.run_to_completion()           # registers the 2-page prefix
    rs = [eng.submit(np.concatenate([sysp, t]), max_new_tokens=10,
                     seed=50 + i)
          for i, t in enumerate([prompt(9, 5), prompt(10, 7)])]
    moved = 0
    for _ in range(200):
        eng.step()
        if not moved:
            for g in range(eng.n_slots):
                if not (eng._active[g] and eng._slots[g] in rs):
                    continue
                shard, slot = divmod(g, eng.slots_per_shard)
                s = eng._sched.shards[shard]
                if not any(s.ref[p] > 1 for p in s.slot_pages[slot].values()):
                    continue          # wait for a shared mapping
                dst = eng._sched.migration_target(shard, slot)
                if dst is not None:
                    eng._migrate_slot(shard, slot, dst)
                    eng.assert_pool_accounting()
                    eng.assert_local_page_tables()
                    moved = 1
                    break
        if all(r.done for r in rs):
            break
    assert all(r.done for r in rs)
    eng.assert_pool_accounting()
    return summary(eng, [r0] + rs, moved=moved)


SCENARIOS = {f"exactness_{c}": _exactness(c) for c in EXACTNESS}
SCENARIOS.update(shared_cow=shared_cow)


# -------------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def reference():
    res = JaxResults(os.path.abspath(__file__))
    yield res
    res.close()


@pytest.fixture(scope="module")
def port(reference):
    return run_scenarios(Api("torch"), SCENARIOS)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, reference, port):
    assert_same(port[name], reference.get()[name], name)


@pytest.mark.parametrize("case", sorted(EXACTNESS))
def test_migrated_stream_equals_stay_put_twin(case, port):
    """The moved slot's stream equals a run without the move."""
    arch, kw, lens, new = EXACTNESS[case]
    eng = Api("torch").engine(arch, 4, n_slots=8, max_len=64, page_size=8,
                              **kw)
    stay, moved = run_traffic(eng, lens, max_new=new)
    assert moved == 0 and port[f"exactness_{case}"]["moved"] == 1
    assert port[f"exactness_{case}"]["tokens"] == \
        [list(r.out_tokens) for r in stay]
    assert port[f"exactness_{case}"]["counters"]["migrations"] == 1


def test_shared_pages_move_intact(port):
    res = port["shared_cow"]
    assert res["moved"] == 1 and res["counters"]["migrations"] == 1
    api = Api("torch")
    eng = api.engine("smollm-360m", 4, n_slots=8, max_len=64, page_size=8)
    sysp = prompt(0, 16)
    eng.submit(sysp.copy(), max_new_tokens=2)
    eng.run_to_completion()
    rs = [eng.submit(np.concatenate([sysp, t]), max_new_tokens=10,
                     seed=50 + i)
          for i, t in enumerate([prompt(9, 5), prompt(10, 7)])]
    eng.run_to_completion()
    assert res["tokens"][1:] == [list(r.out_tokens) for r in rs]


def test_migration_cost_is_the_ucie_closed_form():
    """The port's serving code prices a move only through
    `core/ucie.transfer` (via `migration_ticks`), as the reference's."""
    import inspect

    from repro_torch.core import ucie
    from repro_torch.serve import migration, sharded
    src = inspect.getsource(migration)
    assert "ucie.migration_ticks(" in src and "ucie.transfer(" in src
    assert "transfer(" not in inspect.getsource(sharded)
    assert "transfer(" in inspect.getsource(ucie.migration_ticks)
