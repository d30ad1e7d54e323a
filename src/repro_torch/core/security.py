"""I3 — Distributed chiplet security: AuthenTree-style tree MPC attestation
(port of `repro/core/security.py`).

Two layers:

1. A *cost model* (torch) for the latency/energy the security fabric adds:
   boot-time attestation walks a binary tree of chiplets with one MPC round per
   level (depth = ceil(log2 n)); steady-state traffic pays per-message AEAD
   cost on every UCIe transfer. Used by the time-stepped SoC simulator.

2. A *functional* attestation implementation (pure Python, hashlib): a Merkle
   tree over per-chiplet identity digests with HMAC-sealed roots, byte for
   byte the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac as _hmac
import math
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.rounding import const

# ---------------------------------------------------------------------------
# 1. Cost model (torch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SecurityConfig:
    enabled: bool = True
    mpc_round_us: float = 3.0        # one tree-level multi-party round
    aead_us_per_kb: float = 0.04     # AES-GCM line-rate engine cost
    aead_pj_per_byte: float = 2.0
    reattest_period_ms: float = 100.0  # periodic re-attestation


def _enabled(cfg: SecurityConfig, device) -> torch.Tensor:
    """`cfg.enabled` as f32 0/1: a bool, or a tensor of per-design flags
    (batched sweeps), which keeps its own device."""
    if isinstance(cfg.enabled, torch.Tensor):
        return cfg.enabled.to(torch.float32)
    return torch.tensor(float(cfg.enabled), dtype=torch.float32,
                        device=resolve_device(device))


def attestation_latency_us(n_chiplets: int, cfg: SecurityConfig,
                           device=None) -> torch.Tensor:
    """Boot attestation latency: one MPC round per tree level.

    AuthenTree's tree topology gives O(log n) rounds vs O(n) for a centralized
    root-of-trust chain — the paper's scalability argument. The cost is gated
    branchlessly on `cfg.enabled`.
    """
    depth = max(1, math.ceil(math.log2(max(n_chiplets, 2))))
    return _enabled(cfg, device) * float(depth * cfg.mpc_round_us)


def centralized_attestation_latency_us(
    n_chiplets: int, cfg: SecurityConfig, device=None
) -> torch.Tensor:
    """The baseline the paper argues against: serial chain through one RoT."""
    return _enabled(cfg, device) * float(n_chiplets * cfg.mpc_round_us)


def aead_overhead(
    payload_bytes: torch.Tensor, cfg: SecurityConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(time_us, energy_mj) for authenticated encryption of one transfer,
    on `payload_bytes`' device; branchless in `cfg.enabled`."""
    p = torch.as_tensor(payload_bytes, dtype=torch.float32)
    en = _enabled(cfg, p.device)
    # the constant factors folded into one, as the compiled reference has it
    t = en * p * const(1.0 / 1024.0, cfg.aead_us_per_kb)
    e = en * p * const(cfg.aead_pj_per_byte, 1e-9)
    return t, e


# ---------------------------------------------------------------------------
# 2. Functional Merkle attestation (Python)
# ---------------------------------------------------------------------------


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def leaf_digest(name: str, payload: bytes) -> bytes:
    """Identity digest of one 'chiplet' (or checkpoint shard)."""
    return _h(b"leaf:" + name.encode() + b":" + _h(payload))


def merkle_root(leaves: Sequence[bytes]) -> bytes:
    """Root of a binary Merkle tree (odd nodes promoted)."""
    if not leaves:
        return _h(b"empty")
    level: List[bytes] = list(leaves)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(_h(b"node:" + level[i] + level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def merkle_proof(leaves: Sequence[bytes], index: int) -> List[Tuple[bool, bytes]]:
    """Inclusion proof for leaf `index`: list of (sibling_is_right, digest)."""
    proof: List[Tuple[bool, bytes]] = []
    level = list(leaves)
    idx = index
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(_h(b"node:" + level[i] + level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        sib = idx ^ 1
        if sib < len(level) and sib != idx:
            proof.append((sib > idx, level[sib]))
        idx //= 2
        level = nxt
    return proof


def verify_proof(
    leaf: bytes, proof: Sequence[Tuple[bool, bytes]], root: bytes
) -> bool:
    node = leaf
    for sibling_is_right, sib in proof:
        node = _h(b"node:" + (node + sib if sibling_is_right else sib + node))
    return _hmac.compare_digest(node, root)


def seal(root: bytes, key: bytes) -> bytes:
    """HMAC seal over the Merkle root (session key from the MPC handshake)."""
    return _hmac.new(key, b"seal:" + root, hashlib.sha256).digest()


def verify_seal(root: bytes, key: bytes, tag: bytes) -> bool:
    return _hmac.compare_digest(seal(root, key), tag)


def attest_manifest(payloads: Dict[str, bytes], key: bytes) -> Dict[str, str]:
    """Build a sealed attestation manifest over named payloads."""
    names = sorted(payloads)
    leaves = [leaf_digest(n, payloads[n]) for n in names]
    root = merkle_root(leaves)
    return {
        "names": ",".join(names),
        "root": root.hex(),
        "seal": seal(root, key).hex(),
    }


def verify_manifest(
    payloads: Dict[str, bytes], key: bytes, manifest: Dict[str, str]
) -> bool:
    names = sorted(payloads)
    if ",".join(names) != manifest["names"]:
        return False
    leaves = [leaf_digest(n, payloads[n]) for n in names]
    root = merkle_root(leaves)
    if root.hex() != manifest["root"]:
        return False
    return verify_seal(root, key, bytes.fromhex(manifest["seal"]))
