"""Runtime capture / host-sync sanitizer for the serving engines' static
steps (port of `repro/analysis/sanitizer.py`).

The serving stack's hot loop carries documented budgets: ONE chunk step
and at most two decode steps (greedy, and the lazily built sampled one) a
fixed engine, one monolithic prefill and one paste step a bucket length
(O(log max_len)), one page move a sharded engine, and ZERO new steps once
traffic reaches steady state. Where
the reference counts jit traces and XLA compiles, the port counts step
builds: a `serve/graphs.StepGraph` capturing its CUDA graph (on the CPU,
building its static buffers on the first call, as a trace is in JAX).

  * `watch()` — context manager counting every step build and every
    explicit device->host conversion (`Tensor.cpu()`, `.item()`,
    `.tolist()`, `.numpy()`) inside the region. A chained conversion
    (`t.cpu().numpy()`) counts once: the host tensor that `.cpu()`
    returns, and any pinned staging tensor, is not a device value. On a
    CPU engine the CPU stands in for the device: `.cpu()` of a host tensor
    converts nothing and the `.numpy()` after it counts, so the same call
    sites count once.
  * `register_entry_point(name, step)` — engines label their steps
    (`ENGINE_LABELS`: "decode", "chunk", "prefill", "paste", "move", the
    reference's labels); each step's build counts under its label, so
    they attribute exactly; `entry_cache_sizes()` sums the live steps'
    `captures`. A step built under no label (the encoder-decoder's
    encoder and cross K/V, which the reference jits unlabelled) counts in
    a watch's total only.
  * `compile_budget(decode=2, chunk=1, total=None, host_syncs=None)` —
    context manager that raises `CompileBudgetExceeded` when a label, the
    region's total builds or its host syncs exceed their budget.

Registration holds weak references only: engines and their steps die
normally, and dead entries are pruned on read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import Counter
from typing import Dict, Iterator, List, Optional

import torch


class CompileBudgetExceeded(AssertionError):
    """A step label (or the watched region) blew its capture or sync
    budget. An AssertionError, so plain pytest handling applies."""


@dataclasses.dataclass
class WatchLog:
    """Counters for one watched region (filled while active; the per-label
    deltas stamped at exit)."""
    compiles: int = 0        # step builds anywhere in the process
    host_syncs: int = 0      # explicit device->host conversions
    entry_compiles: Dict[str, int] = dataclasses.field(default_factory=dict)

    def summary(self) -> Dict[str, int]:
        d = {"compiles": self.compiles, "host_syncs": self.host_syncs}
        d.update({f"{k}_compiles": v for k, v in
                  sorted(self.entry_compiles.items())})
        return d


_active: List[WatchLog] = []
# builds per label since import: monotonic, so a region's deltas stay
# right when engines die inside it
_built: Counter = Counter()


def note_compile(label: Optional[str]) -> None:
    """Called by a step when it builds: counted under its label (none for
    an unlabelled step) and by every active watch."""
    if label is not None:
        _built[label] += 1
    for log in _active:
        log.compiles += 1


# --------------------------------------------------------------------------
# named entry points


# the serving engines' labels, known to `compile_budget` before any engine
# registers a step under them
ENGINE_LABELS = ("decode", "chunk", "prefill", "paste", "move")
_entry_points: Dict[str, List[weakref.ref]] = {
    name: [] for name in ENGINE_LABELS}


def register_entry_point(name: str, step) -> None:
    """Label a step so `compile_budget(name=...)` can attribute its builds.
    Several steps may share a label (the greedy and sampled decode steps
    both register as "decode"); weak references only. `step` is a
    `serve.graphs.StepGraph` or `StepFamily`."""
    if not hasattr(step, "captures"):
        raise TypeError(f"{step!r} has no `captures` count: pass a "
                        "serve.graphs.StepGraph, not the python callable")
    _entry_points.setdefault(name, []).append(weakref.ref(step))


def entry_cache_sizes() -> Dict[str, int]:
    """Live build count per registered label (dead refs pruned). A label
    whose steps all died still reports 0, so a budget naming it stays
    valid across engine teardown."""
    out: Dict[str, int] = {}
    for name, refs in _entry_points.items():
        live = [s for s in (r() for r in refs) if s is not None]
        _entry_points[name] = [weakref.ref(s) for s in live]
        out[name] = sum(s.captures for s in live)
    return out


# --------------------------------------------------------------------------
# watch / budgets

_CONVERSIONS = ("cpu", "item", "tolist", "numpy")


def _is_host_value(t: torch.Tensor) -> bool:
    """A tensor whose conversion moves nothing off the device: the result
    of a conversion already counted, or pinned host staging."""
    return getattr(t, "_sanitizer_host", False) or (
        t.device.type == "cpu" and t.is_pinned())


@contextlib.contextmanager
def _count_host_syncs() -> Iterator[None]:
    """Wrap the conversions on `torch.Tensor` while the outermost watch is
    open; each counted conversion adds one to every active log."""
    orig = {name: getattr(torch.Tensor, name) for name in _CONVERSIONS}

    def wrap(name, fn):
        def wrapped(self, *args, **kwargs):
            # `.cpu()` of a host tensor returns it: no conversion yet
            counted = not _is_host_value(self) and (
                name != "cpu" or self.device.type != "cpu")
            if counted:
                for log in _active:
                    log.host_syncs += 1
            out = fn(self, *args, **kwargs)
            if counted and isinstance(out, torch.Tensor):
                out._sanitizer_host = True
            return out
        wrapped.__name__ = name
        return wrapped

    for name, fn in orig.items():
        setattr(torch.Tensor, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(torch.Tensor, name, fn)


@contextlib.contextmanager
def watch() -> Iterator[WatchLog]:
    """Count step builds and explicit host syncs inside the region. The
    per-label build deltas are stamped on the log at exit."""
    log = WatchLog()
    before = dict(_built)
    outer = not _active
    _active.append(log)
    try:
        with (_count_host_syncs() if outer else contextlib.nullcontext()):
            yield log
    finally:
        _active.remove(log)
        log.entry_compiles = {name: _built[name] - before.get(name, 0)
                              for name in _entry_points}


@contextlib.contextmanager
def compile_budget(total: Optional[int] = None,
                   host_syncs: Optional[int] = None,
                   **entries: int) -> Iterator[WatchLog]:
    """Assert budgets over a region:

        with compile_budget(**ServeEngine.COMPILE_BUDGETS):
            ... build and run the engine ...

    Keyword budgets name registered labels (their builds in the region
    must stay <= the budget); `total` caps step builds process-wide;
    `host_syncs` caps explicit device->host conversions. Raises
    CompileBudgetExceeded listing every violation. Unknown labels raise
    ValueError at exit (a misspelled label would otherwise pass
    vacuously); labels registered inside the region count."""
    with watch() as log:
        yield log
    known = set(entry_cache_sizes())
    unknown = sorted(set(entries) - known)
    if unknown:
        raise ValueError(
            f"compile_budget: unknown entry point(s) {unknown}; "
            f"registered: {sorted(known)}")
    violations = []
    for name, budget in sorted(entries.items()):
        got = log.entry_compiles.get(name, 0)
        if got > budget:
            violations.append(f"{name}: {got} captures > budget {budget}")
    if total is not None and log.compiles > total:
        violations.append(f"total: {log.compiles} step builds > budget "
                          f"{total}")
    if host_syncs is not None and log.host_syncs > host_syncs:
        violations.append(f"host_syncs: {log.host_syncs} > budget "
                          f"{host_syncs}")
    if violations:
        raise CompileBudgetExceeded(
            "compile budget exceeded — " + "; ".join(violations) +
            " (a new step in a hot loop means a shape, a dtype or a Python "
            "value leaked into what the step captured)")
