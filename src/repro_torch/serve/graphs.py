"""Fixed-shape steps, captured once as CUDA graphs: the port's counterpart
of the reference engine's `jax.jit` of its decode, chunk, prefill and
paste steps, of the sharded engine's page move and of the train loop's
step (`launch/steps.CapturedTrainStep`).

A `StepGraph` owns static buffers for a step's inputs: one pinned host
staging buffer and one device buffer, both holding every input of a
numpy dtype (bool, int32, int64, f32) at a fixed offset, so a call uploads
the tick's host inputs in ONE non-blocking copy, and none when every input
came as a tensor. An input given as a tensor is copied on the device into
its buffer; one of another dtype (a train batch's bf16 patch rows or
frames) has a device buffer of its own and no staging span. The step function reads its inputs
only from those device buffers and the owner's state (pools, page table,
positions, weights; a train state's params, m, v and step counter), which
it writes in place.

On a CUDA device the first call runs the step for real: that call is the
tick's result and its kernel launches count. The step object then captures
the same call into a `torch.cuda.CUDAGraph`, which executes nothing (a
decode step writes K/V rows in place, so a warm-up run would apply the
step twice). Every later call copies its inputs into the static buffers
and replays the graph. On the CPU, and for an engine built with
`eager=True`, every call runs the function on the same static buffers
without capture, so the CPU tests exercise the same code and counters; a
"build" there is the first call, as a trace is in JAX.

The step counts a build (capture) on its engine's counter and in the
sanitizer (`analysis/sanitizer`), so the counters mean what the
reference's do: programs built, not calls. Before every later call it
checks that each state tensor it read at build still has the address it
captured, and raises on a mismatch: a rebound pool would otherwise give
wrong tokens silently. Nothing re-captures, and nothing falls back: a
capture that raises leaves the step unbuilt and the error to the caller.

Kernel launch counters (`LAUNCHES` in the kernel modules) are incremented
in Python when a wrapper launches; a capture adds nothing to them and each
replay adds the per-kernel counts its capture recorded, so a captured
engine's counts equal steps x layers as an eager one's do.

A `StepFamily` is one step of many signatures, as a `jax.jit` cache holds
one program for each shape of its arguments: monolithic prefill has one
signature a bucket length (and a vlm prompt one a patch count), the paste
one a bucket length. Each new signature is one build of its own
`StepGraph`, counted on the engine's counter and under the family's
label; a family built `per_op` (the recurrent families' exact-length
prefill, one signature a prompt length) counts its builds and never
captures.

Every step of an engine replays on one stream, one after another, and its
graphs share the engine's memory pool. A replay may overwrite any memory
of that pool that another graph's capture left free, its outputs included,
so a step's outputs are read before the next replay: the decode step's
tokens and logits by the tick's host sync. A step whose output another
step consumes (prefill -> paste) does not hand it over through the pool:
the prefill writes its rows into a hand-off buffer allocated outside
every graph, one a bucket length, which only the prefill of that length
writes and the paste that follows it reads.
"""

from __future__ import annotations

import weakref
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import sanitizer

# byte alignment of each input inside the staging buffers
_ALIGN = 16
_CAPTURE_STREAMS: Dict[str, torch.cuda.Stream] = {}


def launch_counters() -> List[Counter]:
    """Every kernel wrapper's launch counter."""
    from repro_torch.kernels import (
        decode_attention, flash_attention, int8_matmul, quantize)
    return [decode_attention.LAUNCHES, flash_attention.LAUNCHES,
            flash_attention.DENSE_LAUNCHES, int8_matmul.LAUNCHES,
            quantize.LAUNCHES]


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    key = str(device)
    s = _CAPTURE_STREAMS.get(key)
    if s is None:
        s = _CAPTURE_STREAMS[key] = torch.cuda.Stream(device=device)
    return s


# the numpy dtype of each input dtype a step stages from host values; an
# input of another dtype (bf16) is given as a tensor
_NUMPY = {torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64,
          torch.float32: np.float32}


class StepGraph:
    """One fixed-shape step of an engine.

    `fn(owner, inputs)` runs the step: `inputs` maps each name of `spec`
    ({name: (shape, torch dtype)}) to its static device tensor; it returns
    a tensor, a tuple of tensors or None. `state(owner)` lists every state
    tensor the step reads (the addresses a capture keeps). `owner` is held
    weakly, so an engine and its graphs die together; `stat` names the
    owner's `EngineStats` counter that a build increments, and `label` the
    sanitizer's. `pool` is the owner's CUDA graph memory pool, shared by
    its steps (they replay one after another on one stream). `stat` None
    counts on no counter, `label` None under no label (the build still
    counts in a watch's total); `register=False` leaves the label's
    registration to a `StepFamily`. A capture starts from an emptied
    allocator cache (`torch.cuda.graph` empties it on entry), so its pool
    does not sit beside what the first call freed (a train step's
    activations and gradients)."""

    def __init__(self, owner, fn: Callable, spec: Dict[str, Tuple],
                 *, state: Callable, stat: Optional[str],
                 label: Optional[str], device, eager: bool, pool=None,
                 register: bool = True):
        self._owner = weakref.ref(owner)
        self.fn, self.state, self.stat, self.label = fn, state, stat, label
        self.device = torch.device(device)
        self.use_graph = self.device.type == "cuda" and not eager
        self.pool = pool
        self.captures = 0
        self.replays = 0
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self._out = None
        self._ptrs: Optional[List[int]] = None
        self._deltas: List[Tuple[Counter, Dict[str, int]]] = []
        self._held: List[torch.Tensor] = []
        # one staging buffer for every input of a numpy dtype, each at an
        # aligned offset
        spans, nbytes = {}, 0
        for name, (shape, dtype) in spec.items():
            if dtype not in _NUMPY:
                continue
            size = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            spans[name] = slice(nbytes, nbytes + size)
            nbytes += -(-max(size, 1) // _ALIGN) * _ALIGN
        pinned = self.device.type == "cuda"
        self._host = torch.zeros(nbytes, dtype=torch.uint8,
                                 pin_memory=pinned)
        self._dev = self._host if not pinned else torch.zeros(
            nbytes, dtype=torch.uint8, device=self.device)
        self._host._sanitizer_host = True     # staging: no device value
        host_np = self._host.numpy()
        self._host_np: Dict[str, np.ndarray] = {}
        self.inputs: Dict[str, torch.Tensor] = {}
        for name, (shape, dtype) in spec.items():
            if dtype not in _NUMPY:
                self.inputs[name] = torch.zeros(shape, dtype=dtype,
                                                device=self.device)
                continue
            span = spans[name]
            self._host_np[name] = host_np[span].view(
                _NUMPY[dtype]).reshape(shape)
            self.inputs[name] = self._dev[span].view(dtype).view(shape)
        self._uploaded = torch.cuda.Event() if pinned else None
        if register and label is not None:
            sanitizer.register_entry_point(label, self)

    @property
    def captured(self) -> bool:
        """Built as a CUDA graph (every later call replays it)."""
        return self.graph is not None

    def _state_ptrs(self, owner) -> List[int]:
        return [t.data_ptr() for t in self.state(owner)]

    def _stage(self, values: Dict[str, object]) -> None:
        """Host values through the pinned staging buffer in one copy (none
        when there is no host value), then tensors (on the step's device,
        any dtype) by a copy each into their static buffers."""
        tensors = {n: values[n] for n in self.inputs
                   if isinstance(values[n], torch.Tensor)}
        host = [n for n in self.inputs if n not in tensors]
        for name in host:
            if name not in self._host_np:
                raise TypeError(f"input {name!r} of dtype "
                                f"{self.inputs[name].dtype} must be a tensor")
        if host:
            if self._uploaded is not None:
                # the previous upload must have left the staging buffer
                self._uploaded.synchronize()
            for name in host:
                self._host_np[name][...] = values[name]
            if self._dev is not self._host:
                self._dev.copy_(self._host, non_blocking=True)
                self._uploaded.record()
        for name, value in tensors.items():
            self.inputs[name].copy_(value)

    def __call__(self, **values):
        """Run the step on `values` (one per input: numpy arrays or
        scalars, or tensors): build on the first call, replay (or rerun)
        after."""
        owner = self._owner()
        self._stage(values)
        if self._ptrs is None:
            out = self.fn(owner, self.inputs)
            self._build(owner)
            return out
        if self._state_ptrs(owner) != self._ptrs:
            raise RuntimeError(
                f"{self.label or 'the'} step of {type(owner).__name__}: a "
                "state tensor it captured was rebound (its address "
                "changed); the state must be written in place")
        if self.graph is None:
            return self.fn(owner, self.inputs)
        self.graph.replay()
        self.replays += 1
        for counter, delta in self._deltas:
            counter.update(delta)
        return self._out

    def _build(self, owner) -> None:
        # the addresses are kept only once the build succeeded: a failed
        # capture leaves the step unbuilt, never running per op after
        ptrs = self._state_ptrs(owner)
        if self.use_graph:
            self._capture(owner, ptrs)
        self._ptrs = ptrs
        self.captures += 1
        if self.stat is not None:
            stats = owner.stats
            setattr(stats, self.stat, getattr(stats, self.stat) + 1)
        sanitizer.note_compile(self.label)

    def _capture(self, owner, ptrs: List[int]) -> None:
        from repro_torch.kernels import _build
        counters = launch_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        deltas = []
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  stream=_capture_stream(self.device)):
                out = self.fn(owner, self.inputs)
        finally:
            # a capture executes nothing: its launches count on its replays
            for c, b in zip(counters, before):
                delta = {k: v - b.get(k, 0) for k, v in c.items()
                         if v != b.get(k, 0)}
                c.clear()
                c.update(b)
                if delta:
                    deltas.append((c, delta))
        self._deltas = deltas
        if self._state_ptrs(owner) != ptrs:
            raise RuntimeError(f"{self.label or 'the'} step rebound a state "
                               "tensor while it was captured")
        self.graph, self._out = graph, out
        # the kernels' scratch counters this graph read stay alive with it
        self._held = list(_build._SEMAPHORES.values())



class StepFamily:
    """One step of many signatures, as a `jax.jit` cache is keyed by its
    arguments' shapes and dtypes.

    `fn(owner, inputs, key)` runs the step of signature `key` (a hashable
    value that fixes every shape the step sees, the inputs' among them);
    `state(owner, key)` lists the state tensors it reads. A call
    `family(key, spec, **values)` builds a `StepGraph` of `spec` the first
    time it sees `key` (one build on the engine's counter `stat` and under
    `label`) and runs that step after. `per_op=True`: every signature runs
    per op, never captured (a step whose signature changes from call to
    call, built for one call). `stat` and `label` None: counted on no
    counter and under no label (the train step, which the reference
    labels nowhere)."""

    def __init__(self, owner, fn: Callable, *, state: Callable,
                 stat: Optional[str], label: Optional[str], device,
                 eager: bool, pool=None, per_op: bool = False):
        self._owner = weakref.ref(owner)
        self.fn, self.state, self.stat, self.label = fn, state, stat, label
        self.device, self.pool = device, pool
        self.eager = eager or per_op
        self.per_op = per_op
        self.members: Dict[object, StepGraph] = {}
        if label is not None:
            sanitizer.register_entry_point(label, self)

    @property
    def captures(self) -> int:
        """Builds over every signature."""
        return sum(m.captures for m in self.members.values())

    @property
    def replays(self) -> int:
        """Graph replays over every signature."""
        return sum(m.replays for m in self.members.values())

    @property
    def captured(self) -> bool:
        """Every built signature is a CUDA graph."""
        built = [m for m in self.members.values() if m.captures]
        return bool(built) and all(m.captured for m in built)

    def __call__(self, key, spec: Dict[str, Tuple], **values):
        step = self.members.get(key)
        if step is None:
            fn, state = self.fn, self.state
            step = self.members[key] = StepGraph(
                self._owner(), lambda o, inp: fn(o, inp, key), spec,
                state=lambda o: state(o, key), stat=self.stat,
                label=self.label, device=self.device, eager=self.eager,
                pool=self.pool, register=False)
        return step(**values)
