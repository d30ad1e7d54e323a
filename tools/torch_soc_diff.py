#!/usr/bin/env python3
"""Where the port's SoC simulator parts from the reference, tick by tick.

    python tools/torch_soc_diff.py [--scenario ai_optimized] [--rate 1000]
                                   [--ticks 2000] [--paper] [--design N]

Runs one design point at one arrival rate (MobileNetV2) through the
reference's simulator (`repro.core.soc`, compiled as `simulate_batch`
compiles it: jit of a double vmap, here over a 1 × 1 batch) and through the
port's batched core (`repro_torch.core.soc`), both on the CPU. The default
is the hot variant (`repro_torch.core.soc.hot_variant`) of ai_optimized at
1,000 images/s, the point that migrates and throttles; `--paper` takes the
paper's floorplan, `--design N` row N of `chip_smoke.py` (j4)'s perturbed
design sweep around it.

The reference's scan is run with every tick's carry kept (the tick
function unchanged; the tool checks that its metrics equal an unpatched
run's). For each tick it compares every carried field (DVFS levels, EMA and
energy; temperatures, migration and throttle counts; the link queue; NPU
queues; staged, completed, busy, energy, queue integral) and the two
per-tick observations bit for bit, and prints the first tick and field that
differ, with both values, then the final metrics of both.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

FIELDS = ("dvfs.level", "dvfs.load_ema", "dvfs.energy_mj", "thermal.temp_c",
          "thermal.migrations", "thermal.throttle_ticks", "link.queued_bytes",
          "link.wire_bytes_total", "link.energy_mj", "npu_queue_ms",
          "staged_images", "completed", "busy_ms", "energy_mj",
          "queue_integral", "obs.max_temp_c", "obs.power_mw")


def design_point(scenario: str, hot: bool, design):
    """The port's SoCConfig and one design point's SoCParams as numpy
    arrays: the scenario's own, or row `design` of `chip_smoke.py` (j4)'s
    sweep (every continuous leaf scaled by `prng.uniform(key(0), (N, 30),
    0.8, 1.2)`; a row does not depend on N)."""
    from repro_torch import prng
    from repro_torch.core import soc as tsoc
    from repro_torch.core.scenarios import SCENARIOS

    soc = tsoc.build_soc(SCENARIOS[scenario])
    soc = tsoc.hot_variant(soc) if hot else soc
    p = tsoc.soc_params(soc, "cpu")
    if design is not None:
        factors = prng.uniform(prng.key(0), (design + 1, 30), 0.8, 1.2)
        p = tsoc.scale_designs(p, factors[design:design + 1])
        p = p.map(lambda x: x[0])
    return soc, {k: v.numpy() for k, v in vars(p).items()}


def reference_trajectory(soc, params, rate: float, ticks: int):
    """Every tick's carry and observations of the reference for one design
    point, and its final metrics; the scan's carries come out as extra
    per-tick outputs."""
    import jax
    import jax.numpy as jnp

    from repro.core import soc as jsoc
    from repro.core.workloads import MOBILENET_V2
    from repro_torch.core.soc import _npu_mask, _static_residual

    npu_mask = _npu_mask(soc)
    # the port's static residual holds the same Python values
    static = _reference_static(_static_residual(soc))
    p = jsoc.SoCParams(**{k: jnp.asarray(v)[None] for k, v in params.items()})
    rates = jnp.asarray([rate], jnp.float32)
    plain = jsoc._batch_fn(MOBILENET_V2, npu_mask, static, ticks,
                           soc.tick_ms)(p, rates)

    real_scan = jax.lax.scan
    kept = []

    def scan_keeping_carries(f, init, xs, length):
        def body(c, x):
            c2, y = f(c, x)
            return c2, (y, c2)
        final, (ys, carries) = real_scan(body, init, xs, length=length)
        kept[:] = [carries, ys]
        return final, ys

    def core(p, r):
        jax.lax.scan = scan_keeping_carries
        try:
            out = jsoc._simulate_params(
                p, r, workload=MOBILENET_V2, npu_mask=npu_mask,
                static=static, ticks=ticks, tick_ms=soc.tick_ms)
            return out, kept[0], kept[1]
        finally:
            jax.lax.scan = real_scan

    fn = jax.jit(jax.vmap(jax.vmap(core, in_axes=(None, 0)),
                          in_axes=(0, None)))
    out, carries, obs = fn(p, rates)
    for k in plain:
        a, b = np.asarray(plain[k]), np.asarray(out[k])
        assert np.array_equal(a, b, equal_nan=True), \
            f"keeping the carries changed the reference's {k}: {a} vs {b}"
    leaves = [np.asarray(x)[0, 0] for x in jax.tree.leaves(carries)]
    leaves += [np.asarray(x)[0, 0] for x in obs]
    return dict(zip(FIELDS, leaves)), {k: np.asarray(v)[0, 0]
                                       for k, v in out.items()}


def _reference_static(static):
    """The port's static residual as the reference's config classes."""
    import dataclasses

    from repro.core import dvfs, security, thermal, ucie
    ucie_s, dvfs_s, thermal_s, sec_s = static
    return (ucie.UCIeConfig(**dataclasses.asdict(ucie_s)),
            dvfs.DVFSConfig(**dataclasses.asdict(dvfs_s)),
            thermal.ThermalConfig(**dataclasses.asdict(thermal_s)),
            security.SecurityConfig(**dataclasses.asdict(sec_s)))


def port_trajectory(soc, params, rate: float, ticks: int):
    import torch

    from repro_torch.bridge import soc_params_from_numpy
    from repro_torch.core import soc as tsoc
    from repro_torch.core.workloads import MOBILENET_V2

    p = soc_params_from_numpy({k: v[None, None] if v.ndim == 0
                               else v[None, None, :]
                               for k, v in params.items()})
    rates = torch.tensor([[rate]], dtype=torch.float32)
    p, rates, batch = tsoc._broadcast(p, rates)
    tick = tsoc._Tick(p, rates, workload=MOBILENET_V2,
                      npu_mask=tsoc._npu_mask(soc),
                      static=tsoc._static_residual(soc), tick_ms=soc.tick_ms)
    n = p.peak_dyn_mw.shape[-1]
    state = tsoc.init_sim_state(n, tick.dvfs_cfg, tick.thermal_cfg, batch,
                                torch.device("cpu"))
    traj = {f: [] for f in FIELDS}
    for _ in range(ticks):
        state, obs = tick(state)
        s = state
        vals = (s.dvfs.level, s.dvfs.load_ema, s.dvfs.energy_mj,
                s.thermal.temp_c, s.thermal.migrations,
                s.thermal.throttle_ticks, s.link.queued_bytes,
                s.link.wire_bytes_total, s.link.energy_mj, s.npu_queue_ms,
                s.staged_images, s.completed, s.busy_ms, s.energy_mj,
                s.queue_integral, obs[0], obs[1])
        for f, v in zip(FIELDS, vals):
            traj[f].append(v[0, 0].numpy().copy())
    fn = tsoc._batch_fn(MOBILENET_V2, tsoc._npu_mask(soc),
                        tsoc._static_residual(soc), ticks, soc.tick_ms)
    out = fn(soc_params_from_numpy({k: v[None] for k, v in params.items()}),
             torch.tensor([rate], dtype=torch.float32))
    return ({f: np.stack(v) for f, v in traj.items()},
            {k: v.numpy()[0, 0] for k, v in out.items()})


def first_difference(ref, port, ticks):
    """(tick, [(field, reference, port), ...]) of the first tick at which
    any field differs bit for bit, every differing field of that tick."""
    for t in range(ticks):
        bad = []
        for f in FIELDS:
            a, b = ref[f][t], port[f][t]
            if a.dtype.kind == "f":
                same = np.array_equal(a.view(np.int32), b.view(np.int32))
            else:
                same = np.array_equal(a, b)
            if not same:
                bad.append((f, a, b))
        if bad:
            return t, bad
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="ai_optimized")
    ap.add_argument("--rate", type=float, default=1000.0)
    ap.add_argument("--ticks", type=int, default=2000)
    ap.add_argument("--paper", action="store_true",
                    help="the paper's floorplan instead of the hot variant")
    ap.add_argument("--design", type=int, default=None,
                    help="row of chip_smoke.py (j4)'s perturbed designs")
    args = ap.parse_args(argv)
    hot = not args.paper
    soc, params = design_point(args.scenario, hot, args.design)
    ref, ref_out = reference_trajectory(soc, params, args.rate, args.ticks)
    port, port_out = port_trajectory(soc, params, args.rate, args.ticks)
    what = "hot variant" if hot else "paper floorplan"
    if args.design is not None:
        what += f", design {args.design}"
    print(f"{args.scenario} ({what}) at {args.rate:g} images/s, "
          f"{args.ticks} ticks")
    first = first_difference(ref, port, args.ticks)
    if first is None:
        print("every carried field and observation is bit-equal at every "
              "tick")
    else:
        t, bad = first
        print(f"first difference: tick {t}, fields "
              f"{', '.join(f for f, _, _ in bad)}")
        for f, a, b in bad:
            a, b = np.atleast_1d(a), np.atleast_1d(b)
            for i in np.flatnonzero(a != b):
                print(f"  {f}[{i}] reference {a[i]!r} port {b[i]!r}")
    print(f"{'metric':18s} {'reference':>16s} {'port':>16s}")
    for k in ref_out:
        print(f"{k:18s} {float(ref_out[k]):16.9g} {float(port_out[k]):16.9g}")
    return 0 if first is None else 1


if __name__ == "__main__":
    sys.exit(main())
