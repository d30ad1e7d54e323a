#!/usr/bin/env python3
"""Where the wide dense flash-attention kernel spends its time, on the card.

    python tools/torch_flash_parts.py        # needs a CUDA card and nvcc

Builds `csrc/flash_attention.cu` (head_dim 160-256: `flash_wide_kernel`,
one block a row tile walking its splits) several times into a temporary
directory, each build with parts of the kernel compiled out, and times each
build the way `chip_smoke.py` times a kernel (CUDA events, L2 evicted), at
gemma-7b's (1, 16, 1024, 256), causal and not:

    full          the kernel as it is
    skeleton      no tile products, no tile copies after the first two, no
                  split partials stored, no merge: prologue, barriers, loop
    +stores       the skeleton and the split partials' stores to scratch
    +stores+merge the skeleton, the stores and the merge that reads them
    no scratch    everything but the stores and the merge

The builds are only for timing: outputs of the reduced builds are not
checked. Also prints the time of `x.sum()` over 110 MB of f32 after the
same eviction, a device-memory read rate for reference.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402

# (file, text, replacement): the guards each part is compiled out by
GUARDS = [
    ("attn_mma.cuh",
     """      if (r) {
        const PairCorr corr = score(r, kt_of(slot), lo, hi);
        pv_tile_pair<DO>(st, corr, vt_of(slot) + hf * DO, SM::VLD, pt, lane);
      }""",
     """#ifndef PARTS_NO_MATH
      if (r) {
        const PairCorr corr = score(r, kt_of(slot), lo, hi);
        pv_tile_pair<DO>(st, corr, vt_of(slot) + hf * DO, SM::VLD, pt, lane);
      }
#endif"""),
    ("attn_mma.cuh",
     """      if (t + 2 < t_last) {
        src.copy_k(j0 + 2 * MT_KEYS, kt_of(slot));""",
     """      if (PARTS_LOADS && t + 2 < t_last) {
        src.copy_k(j0 + 2 * MT_KEYS, kt_of(slot));"""),
    ("flash_attention.cu",
     """    } else if (split + 1 < s_hi) {
      repro::store_split_wide<D>(st, acc_t, ml_t, split, tid);""",
     """    } else if (split + 1 < s_hi) {
      if (PARTS_STORES) repro::store_split_wide<D>(st, acc_t, ml_t, split, tid);"""),
    ("flash_attention.cu",
     """  repro::merge_rows_wide<D>(ml, acc4, s_lo, s_hi, rn, out_row, tid);""",
     """  if (PARTS_MERGE) repro::merge_rows_wide<D>(ml, acc4, s_lo, s_hi, rn, out_row, tid);"""),
]
VARIANTS = {
    "full": [],
    "skeleton": ["-DPARTS_NO_MATH", "-DPARTS_LOADS=0", "-DPARTS_STORES=0", "-DPARTS_MERGE=0"],
    "+stores": ["-DPARTS_NO_MATH", "-DPARTS_LOADS=0", "-DPARTS_MERGE=0"],
    "+stores+merge": ["-DPARTS_NO_MATH", "-DPARTS_LOADS=0"],
    "no scratch": ["-DPARTS_STORES=0", "-DPARTS_MERGE=0"],
}
DEFAULTS = ["-DPARTS_LOADS=1", "-DPARTS_STORES=1", "-DPARTS_MERGE=1"]


def build(tmp: pathlib.Path) -> dict:
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, tmp / f.name)
    shutil.copy(_build.CSRC / "flash_attention.cu", tmp / "flash_attention.cu")
    for name, text, repl in GUARDS:
        src = (tmp / name).read_text()
        if src.count(text) != 1:
            raise SystemExit(f"{name} changed: cannot place a guard at\n{text}")
        (tmp / name).write_text(src.replace(text, repl))
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, flags in VARIANTS.items():
        given = {f.split("=")[0] for f in flags}
        flags = flags + [d for d in DEFAULTS if d.split("=")[0] not in given]
        out = tmp / f"lib_{name.strip('+').replace('+', '_').replace(' ', '_')}.so"
        procs[name] = (out, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-I", str(tmp), "-o", str(out),
             str(tmp / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out)).flash_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    x = torch.ones(110 << 18, device="cuda")
    print(f"x.sum() over 110 MB f32: {time_ms(lambda: x.sum()):.4f} ms")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 16, 1024, 256, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        libs = build(pathlib.Path(tmp))
        saved = fmod._dense_fn
        try:
            for causal in (True, False):
                for name, fn in libs.items():
                    fmod._dense_fn = fn
                    ms = time_ms(lambda: fmod.flash_attention_cuda(q, k, v, causal=causal))
                    print(f"flash_attention (1, 16, 1024, 256) causal={causal} {name}: "
                          f"ms {ms:.4f}", flush=True)
        finally:
            fmod._dense_fn = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
