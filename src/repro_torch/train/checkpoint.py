"""Fault-tolerant checkpointing (port of `repro/train/checkpoint.py`).

The same layout as the JAX package's, so each package restores the other's
checkpoints:
  * `step_<N:08d>/` holds one `.npy` per leaf, named by its tree path
    (`"params/layers/wq"` → `params__layers__wq.npy`), and `manifest.json`
    with each leaf's shape, dtype and sha256 and a Merkle-style root hash
    over the sorted leaf hashes (tamper/corruption detection on restore);
  * atomic publish: write `step_<N>.tmp/`, then rename; a step is written
    once, and saving a step that exists raises before anything is written;
  * retention-k garbage collection.
f32 and int32 leaves are written byte-identical to the JAX package's files.
bf16 leaves are stored as their 16-bit pattern (`uint16` .npy) with
`"dtype": "bfloat16"` in the manifest and restored bit-equal: numpy has no
bfloat16 without `ml_dtypes`, and the JAX package's own bf16 files (`|V2`)
cannot be loaded back by it. Both forms restore here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.tree import tree_from_paths, tree_paths


def _sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_numpy(t: torch.Tensor):
    """(array to save, manifest dtype name)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A freshly loaded (writable, contiguous) array → tensor on `device`."""
    if dtype == "bfloat16":     # uint16 here, `|V2` from the JAX package
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        self.dir = pathlib.Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> str:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if final.exists():
            raise FileExistsError(f"checkpoint {final} exists")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "extra": extra or {},
                    "leaves": {}}
        for key, leaf in sorted(tree_paths(tree).items()):
            arr, dtype = _to_numpy(leaf)
            fname = key.replace("/", "__") + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype,
                "sha256": _sha256(tmp / fname),
            }
        root = hashlib.sha256()
        for key in sorted(manifest["leaves"]):
            root.update(manifest["leaves"][key]["sha256"].encode())
        manifest["root_hash"] = root.hexdigest()
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        os.replace(tmp, final)      # atomic publish
        self._gc()
        return str(final)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device="cpu",
                verify: bool = True):
        """Load every leaf of checkpoint `step` (default: the latest) onto
        `device`. Returns (nested-dict tree, manifest). The JAX package's
        `template` has no counterpart: the manifest's leaf keys give the
        tree."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        if verify:
            self.verify(step)
        values = {key: _from_numpy(np.load(d / meta["file"]), meta["dtype"],
                                   device)
                  for key, meta in manifest["leaves"].items()}
        return tree_from_paths(values), manifest

    # ---------------------------------------------------------------- verify
    def verify(self, step: int) -> bool:
        """Recompute every leaf hash and the root; raise on tamper."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        root = hashlib.sha256()
        for key in sorted(manifest["leaves"]):
            meta = manifest["leaves"][key]
            got = _sha256(d / meta["file"])
            if got != meta["sha256"]:
                raise IOError(
                    f"checkpoint integrity failure: leaf {key!r} hash mismatch "
                    f"(expected {meta['sha256'][:12]}…, got {got[:12]}…)")
            root.update(meta["sha256"].encode())
        if root.hexdigest() != manifest["root_hash"]:
            raise IOError("checkpoint integrity failure: root hash mismatch")
        return True

    def _gc(self):
        steps = sorted(p for p in self.dir.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        for old in steps[:-self.keep]:
            shutil.rmtree(old)
