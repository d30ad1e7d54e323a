"""Build and load the hand-written CUDA kernels (`src/repro_torch/csrc/*.cu`).

Each source compiles with nvcc into its own shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes seconds).
Libraries land in `<repo>/build/repro_torch_kernels/`, named by a hash of the
sources, so an edited kernel rebuilds and an unchanged one is reused. Nothing
here runs at import time: the CPU tests import every module and have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
# every kernel library: name → its .cu source (headers in csrc/ are hashed
# into every library, so an edit to a shared header rebuilds them all)
SOURCES = {
    "int8_matmul": "int8_matmul.cu",
    "decode_attention": "decode_attention.cu",
    "flash_attention_paged": "flash_attention_paged.cu",
    "flash_attention": "flash_attention.cu",
    "quantize_blocks": "quantize_blocks.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_SEMAPHORES: Dict[str, "torch.Tensor"] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, verbose: bool):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / SOURCES[name])]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started, verbose: bool) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    if verbose and log:
        print(f"[build] {name}:\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str] = tuple(SOURCES), verbose: bool = False
          ) -> float:
    """Compile every named kernel library that is not built yet, one nvcc
    per source, all started together. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    names = list(names)
    with _LOCK:
        started = {n: _start(n, verbose) for n in names}
        errors = []
        for n in names:
            try:
                _finish(n, started[n], verbose)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def semaphores(device, n: int):
    """At least `n` zeroed int32 counters on `device` for the split-K and
    split-KV kernels: a kernel counts the blocks of an output tile that are
    done, and the last one resets its counter to 0, so one buffer serves
    every launch on the device's stream in turn. A CUDA graph keeps the
    buffer it captured alive (`serve/graphs.StepGraph`), so the buffer is
    never replaced while a stream is capturing: the step's first run,
    before its capture, sizes it."""
    import torch
    key = str(device)
    sem = _SEMAPHORES.get(key)
    if sem is None or sem.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"semaphores: {n} counters asked for while capturing, past "
                f"the {0 if sem is None else sem.numel()} the step's first "
                "run sized")
        sem = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _SEMAPHORES[key] = sem
    return sem


def check(status: int, name: str) -> None:
    """Raise on the `cudaError_t` a launcher returned (0 = cudaSuccess)."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")
