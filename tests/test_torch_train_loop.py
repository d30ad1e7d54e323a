"""Port parity, the training loop around the step: checkpoints (the same
files as the JAX package's, restored across the two packages, bf16 leaves
bit-equal), `train_loop` (the port resumes a run the JAX package started and
matches its losses; the cases of tests/test_train_loop.py) and the elastic
policies (the cases of tests/test_elastic.py), on smollm-360m `.smoke()`
(float32).

Tolerances: checkpoint leaves bit-equal; the losses of a resumed train_loop
within 1e-4 (the same math in another summation order over 2 steps)."""

import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import steps as jsteps
from repro.launch.train import train_loop as jtrain_loop
from repro.models import ExecOptions, build_model as jbuild
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JCheckpointManager

from repro_torch.bridge import (
    params_from_numpy, params_to_numpy, tensor_from_numpy)
from repro_torch.launch.train import main as train_main, train_loop
from repro_torch.train import elastic as tel
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.tree import tree_paths

# one intra-op thread a test process: under xdist's six workers torch's
# default (a thread a core) oversubscribes the machine several times over
torch.set_num_threads(1)

SEQ, BATCH = 32, 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _same_bytes(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _assert_tree_equal(got, want):
    """got: torch tree; want: numpy/JAX tree with the same keys."""
    want, got = tree_paths(_np_tree(want)), tree_paths(got)
    assert set(got) == set(want)
    for key, w in want.items():
        assert _same_bytes(got[key].detach().numpy(), w), key


@pytest.fixture(scope="module")
def smol():
    cfg = get_config("smollm-360m").smoke()
    return cfg, _np_tree(jbuild(cfg, ExecOptions(attn_impl="reference")).init(
        jax.random.key(0)))


# ---------------------------------------------------------- (f) checkpoint
def _jax_train_state(p, step=7):
    params = jax.tree.map(jnp.asarray, p)
    opt = jopt.init_opt_state(params)
    opt["m"] = jax.tree.map(lambda a: a * 0.5, params)
    opt["v"] = jax.tree.map(lambda a: a * a, params)
    opt["step"] = jnp.int32(step)
    return {"params": params, "opt": opt}


def test_checkpoints_cross_restore(smol, tmp_path):
    cfg, p = smol
    jstate = _jax_train_state(p)
    jm = JCheckpointManager(str(tmp_path / "jax"))
    jm.save(7, jstate, extra={"loss": 1.5})
    tm = CheckpointManager(str(tmp_path / "torch"))
    tstate = params_from_numpy(_np_tree(jstate))
    tm.save(7, tstate, extra={"loss": 1.5})
    # the same files, byte for byte, and the same root hash
    jman = json.loads((tmp_path / "jax/step_00000007/manifest.json").read_text())
    tman = json.loads(
        (tmp_path / "torch/step_00000007/manifest.json").read_text())
    assert tman["root_hash"] == jman["root_hash"]
    assert tman["leaves"] == jman["leaves"]
    # the port restores JAX's checkpoint ...
    got, man = tm.__class__(str(tmp_path / "jax")).restore()
    assert man["step"] == 7 and man["extra"] == {"loss": 1.5}
    assert got["opt"]["step"].dtype == torch.int32 and got["opt"]["step"].dim() == 0
    _assert_tree_equal(got, jstate)
    # ... and JAX restores the port's
    template = jsteps.abstract_train_state(
        jbuild(cfg, ExecOptions(attn_impl="reference")))
    jgot, _ = JCheckpointManager(str(tmp_path / "torch")).restore(template)
    _assert_tree_equal(tstate, jgot)


def test_checkpoint_verify_raises_on_tamper(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    path = pathlib.Path(mgr.save(3, {"w": torch.arange(10.0)}))
    victim = path / "w.npy"
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="integrity"):
        mgr.verify(3)
    with pytest.raises(IOError, match="integrity"):
        mgr.restore()
    tree, _ = mgr.restore(verify=False)
    assert tree["w"].shape == (10,)


def test_checkpoint_gc_keeps_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((3,), float(s))})
    assert mgr.latest_step() == 4
    kept = sorted(x.name for x in tmp_path.iterdir())
    assert kept == ["step_00000003", "step_00000004"]
    tree, _ = mgr.restore(step=3)
    assert tree["w"].tolist() == [3.0, 3.0, 3.0]


def test_bf16_leaf_round_trips_bit_equal(tmp_path):
    bits = np.random.default_rng(4).integers(-2**15, 2**15, (3, 257),
                                             dtype=np.int16)
    w = torch.from_numpy(bits).view(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"params": {"w": w, "n": torch.ones(2, dtype=torch.bfloat16)}})
    man = json.loads((tmp_path / "step_00000000/manifest.json").read_text())
    assert man["leaves"]["params/w"]["dtype"] == "bfloat16"
    tree, _ = mgr.restore()
    assert set(tree["params"]) == {"w", "n"}
    assert tree["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(tree["params"]["w"].view(torch.int16), w.view(torch.int16))


def test_bf16_checkpoint_of_the_jax_package_restores(tmp_path):
    """JAX writes a bf16 leaf as `|V2` .npy, which it cannot load back
    itself; the port reads it through the manifest's dtype."""
    import ml_dtypes
    w = np.random.default_rng(5).standard_normal((4, 6)).astype(
        ml_dtypes.bfloat16)
    JCheckpointManager(str(tmp_path)).save(2, {"w": jnp.asarray(w)})
    tree, _ = CheckpointManager(str(tmp_path)).restore()
    assert _same_bytes(tree["w"].view(torch.int16).numpy(), w.view(np.int16))


def test_train_state_bridge_round_trip(smol):
    _, p = smol
    state = _np_tree(_jax_train_state(p))
    tstate = params_from_numpy(state)
    assert tstate["opt"]["step"].dim() == 0
    assert tstate["opt"]["step"].dtype == torch.int32
    back = params_to_numpy(tstate)
    assert set(tree_paths(back)) == set(tree_paths(state))
    for key, leaf in tree_paths(state).items():
        assert _same_bytes(tree_paths(back)[key], leaf), key


# ---------------------------------------------------------- (g) train_loop
@pytest.mark.parametrize("compress", [False, True])
def test_port_resumes_a_jax_run(tmp_path, compress):
    """JAX trains 3 steps; the port and JAX each resume a copy of its
    directory for 2 more steps: the same data stream, the same losses."""
    kw = dict(arch="smollm-360m", smoke=True, global_batch=BATCH, seq_len=SEQ,
              ckpt_every=0, log_every=100, compress_grads=compress)
    jtrain_loop(steps=3, ckpt_dir=str(tmp_path / "run"), **kw)
    for name in ("jax", "port"):
        shutil.copytree(tmp_path / "run", tmp_path / name)
    jl, _ = jtrain_loop(steps=5, ckpt_dir=str(tmp_path / "jax"), **kw)
    tl, _ = train_loop(steps=5, ckpt_dir=str(tmp_path / "port"), device="cpu",
                       **kw)
    assert len(jl) == len(tl) == 2
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert CheckpointManager(str(tmp_path / "port")).latest_step() == 4


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_train_loop"))


def test_loop_runs_and_checkpoints(run_dir):
    losses, _ = train_loop(
        arch="smollm-360m", smoke=True, steps=12, global_batch=BATCH,
        seq_len=SEQ, ckpt_dir=run_dir, ckpt_every=5, log_every=100,
        device="cpu")
    assert len(losses) == 12
    assert all(np.isfinite(v) for v in losses)
    assert CheckpointManager(run_dir).latest_step() == 11


def test_resume_continues_stream(run_dir):
    losses, _ = train_loop(
        arch="smollm-360m", smoke=True, steps=18, global_batch=BATCH,
        seq_len=SEQ, ckpt_dir=run_dir, ckpt_every=5, log_every=100,
        device="cpu")
    assert len(losses) == 6          # resumed from 11 → steps 12..17
    assert CheckpointManager(run_dir).latest_step() == 17


def test_compressed_grads_path(tmp_path):
    kw = dict(arch="smollm-360m", smoke=True, steps=8, global_batch=BATCH,
              seq_len=SEQ, ckpt_every=0, log_every=100, device="cpu")
    plain, _ = train_loop(ckpt_dir=str(tmp_path / "a"), **kw)
    comp, _ = train_loop(ckpt_dir=str(tmp_path / "b"), compress_grads=True,
                         **kw)
    assert all(np.isfinite(v) for v in comp)
    assert abs(np.mean(comp) - np.mean(plain)) < 0.5


def test_final_save_onto_an_in_loop_checkpoint(tmp_path):
    """steps - 1 a multiple of ckpt_every: the loop has just saved that step
    and the final save is skipped (the reference's rename onto the existing
    directory raises)."""
    losses, _ = train_loop(
        arch="smollm-360m", smoke=True, steps=6, global_batch=BATCH,
        seq_len=SEQ, ckpt_dir=str(tmp_path), ckpt_every=5, log_every=100,
        device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    assert len(losses) == 6 and mgr.latest_step() == 5 and mgr.verify(5)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000005"]


def test_checkpoint_save_refuses_an_existing_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, {"w": torch.ones(3)})
    with pytest.raises(FileExistsError):
        mgr.save(4, {"w": torch.zeros(3)})
    tree, _ = mgr.restore(4)
    assert tree["w"].tolist() == [1.0, 1.0, 1.0]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000004"]


def test_cli_checkpoints_under_the_working_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    losses = train_main(["--smoke", "--device", "cpu", "--steps", "2",
                         "--batch", str(BATCH), "--seq", str(SEQ)])
    assert len(losses) == 2
    assert CheckpointManager(str(tmp_path / "build" / "train_ckpt")) \
        .latest_step() == 1


def test_train_loop_refuses_model_parallel(tmp_path):
    with pytest.raises(NotImplementedError, match="A12"):
        train_loop(arch="smollm-360m", smoke=True, steps=1, global_batch=BATCH,
                   seq_len=SEQ, ckpt_dir=str(tmp_path), model_parallel=2,
                   device="cpu")


# ------------------------------------------------------------- (h) elastic
def _registry(n=4, timeout=10.0):
    return tel.HeartbeatRegistry(n, tel.ElasticPolicy(
        heartbeat_timeout_s=timeout, straggler_patience=4))


def test_dead_host_detected():
    reg = _registry()
    for h in range(4):
        reg.beat(h, 1.0, now=1000.0)
    for h in (0, 1, 3):
        reg.beat(h, 1.0, now=1030.0)
    dec = tel.plan_migration(reg, now=1030.0)
    assert dec.kind == "reshard" and dec.drop_hosts == (2,)


def test_healthy_fleet_no_action():
    reg = _registry()
    t = 0.0
    for _ in range(6):
        t += 1.0
        for h in range(4):
            reg.beat(h, 1.0, now=t)
    assert tel.plan_migration(reg, now=t).kind == "none"


def test_straggler_detected_and_rebalanced():
    reg = _registry()
    t = 0.0
    for _ in range(8):
        t += 1.0
        for h in range(4):
            reg.beat(h, 5.0 if h == 3 else 1.0, now=t)
    assert tel.detect_stragglers(reg) == [3]
    dec = tel.plan_migration(reg, now=t)
    assert dec.kind == "rebalance" and dec.drop_hosts == (3,)


def test_transient_slowness_tolerated():
    reg = _registry()
    t = 0.0
    for step in range(8):
        t += 1.0
        for h in range(4):
            reg.beat(h, 9.0 if (h == 3 and step == 5) else 1.0, now=t)
    assert tel.detect_stragglers(reg) == []


def test_min_hosts_guard():
    reg = tel.HeartbeatRegistry(2, tel.ElasticPolicy(heartbeat_timeout_s=1.0,
                                                     min_hosts=2))
    reg.beat(0, now=100.0)
    reg.beat(1, now=0.0)
    dec = tel.plan_migration(reg, now=100.0)
    assert dec.kind == "none" and "min_hosts" in dec.reason


def test_elastic_mesh_shape():
    assert tel.elastic_mesh_shape(512, 16) == (32, 16)
    assert tel.elastic_mesh_shape(480, 16) == (30, 16)
    with pytest.raises(AssertionError):
        tel.elastic_mesh_shape(8, 16)


def test_rebalanced_batch_split_sums_and_orders():
    split = tel.rebalanced_batch_split(256, {0: 1.0, 1: 1.0, 2: 0.5})
    assert sum(split.values()) == 256
    assert split[2] < min(split[0], split[1])
    assert abs(split[0] - split[1]) <= 1


def test_tensor_bridge_keeps_scalars_scalar():
    t = tensor_from_numpy(np.int32(5))
    assert t.dim() == 0 and t.dtype == torch.int32 and int(t) == 5
