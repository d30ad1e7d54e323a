"""Architecture + input-shape configuration.

One `ArchConfig` per assigned architecture (exact public-literature configs),
plus the four assigned input shapes. `smoke()` derives a reduced same-family
config for CPU tests; the full configs are exercised only via the dry-run.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "swiglu"          # swiglu | geglu
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_fraction: float = 1.0          # chatglm: 0.5 (2D/partial rotary)
    tie_embeddings: bool = False
    embed_scale: bool = False           # gemma: embeddings × sqrt(d_model)
    logit_softcap: float = 0.0
    norm_plus_one: bool = False         # gemma-style (1+w) RMSNorm weights
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0                # qwen2-moe: 4 shared experts (fused)
    capacity_factor: float = 1.25
    moe_group: int = 512                # GShard group size (tokens)
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # --- hybrid (recurrentgemma / Griffin) ---
    block_pattern: Tuple[str, ...] = () # e.g. ('rec','rec','attn')
    lru_width: int = 0
    window: int = 0                     # sliding-window size for local attn
    # --- attention family (deepseek-v2 MLA latent-KV) ---
    # attn_kind='mla' caches ONE (kv_lora_rank + qk_rope_dim)-wide latent row
    # per token instead of per-head K/V (models/mla.py); 'gqa' is the default
    # per-head path. q_lora_rank=0 keeps the direct query projection.
    attn_kind: str = "gqa"              # gqa | mla
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0                 # 0 → head_dim
    # --- enc-dec (seamless) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    cross_len: int = 4096               # encoder length used by decode shapes
    # --- modality frontends (STUBS: precomputed embeddings) ---
    n_image_tokens: int = 0             # vlm: anyres patch tokens per sample
    audio_frontend: bool = False        # encoder consumes (B,S,d) frames
    # --- numerics / distribution-time padding ---
    dtype: str = "bfloat16"
    vocab_round: int = 256              # pad vocab up for even sharding
    # Pad attention heads so (kv_pad × g_pad) is a multiple of the TP axis.
    # Dead heads are hard-masked to zero contribution (exact outputs, zero
    # grads); without this, archs whose head counts don't divide 16 (smollm
    # 15H, qwen2.5 40H, recurrentgemma 10H) would replicate their projections
    # and attention across the whole model axis. Set to the model-axis size
    # by the launcher; 1 (no padding) for smoke tests.
    tp_pad: int = 1

    # ---------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        r = self.vocab_round
        return ((self.vocab_size + r - 1) // r) * r

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def padded_kv_group(self) -> Tuple[int, int]:
        """(kv_pad, g_pad): smallest GQA-aligned padding with
        kv_pad·g_pad ≡ 0 (mod tp_pad)."""
        kv, g, m = self.n_kv_heads, self.q_per_kv, self.tp_pad
        best = None
        for kvp in range(kv, kv + m + 1):
            for gp in range(g, g + m + 1):
                if (kvp * gp) % m == 0 and kvp * gp >= self.n_heads:
                    if best is None or kvp * gp < best[0] * best[1] or (
                            kvp * gp == best[0] * best[1] and kvp == kv):
                        if best is None or kvp * gp < best[0] * best[1]:
                            best = (kvp, gp)
                        elif kvp == kv and best[0] != kv:
                            best = (kvp, gp)
        assert best is not None
        return best

    @property
    def kv_pad(self) -> int:
        return self.padded_kv_group[0]

    @property
    def g_pad(self) -> int:
        return self.padded_kv_group[1]

    @property
    def n_heads_padded(self) -> int:
        kvp, gp = self.padded_kv_group
        return kvp * gp

    @property
    def mla_latent_dim(self) -> int:
        """Width of the single cached MLA row: compressed KV + shared rope."""
        return self.kv_lora_rank + self.qk_rope_dim

    @property
    def mla_qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def mla_v_dim(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def d_inner(self) -> int:           # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Can decode a 524288-token context in O(1)/O(window) state?"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True  # no encoder-only archs in the assignment

    def layer_pattern(self) -> Tuple[str, ...]:
        if not self.block_pattern:
            return ("attn",) * self.n_layers
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def param_count_analytic(self) -> int:
        """6·N·D-style N (total params), analytic."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, n = self.d_inner, self.ssm_state
            per = d * (2 * di + 2 * n + self.ssm_heads) + di * d \
                + self.conv_kernel * (di + 2 * n) + 3 * self.ssm_heads + di
            return emb + self.n_layers * per
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        glu = 3 * d * f
        per = attn + glu
        if self.family == "moe":
            per = attn + self.n_experts * 3 * d * self.d_ff_expert \
                + 3 * d * self.d_ff_shared + d * self.n_experts
        if self.family == "hybrid":
            n_rec = sum(1 for b in self.layer_pattern() if b == "rec")
            n_att = self.n_layers - n_rec
            w = self.lru_width
            rec = 2 * d * w + w * d + self.conv_kernel * w + 4 * w
            return emb + n_rec * (rec + glu) + n_att * (attn + glu)
        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + glu)
            dec = self.n_dec_layers * (2 * attn + glu)
            return emb + enc + dec
        return emb + self.n_layers * per

    def active_param_count(self) -> int:
        """Active params per token (== total except MoE routes top-k)."""
        if self.family != "moe":
            return self.param_count_analytic()
        d = self.d_model
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        act = attn + self.moe_top_k * 3 * d * self.d_ff_expert \
            + 3 * d * self.d_ff_shared + d * self.n_experts
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * act

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        updates = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4 if self.n_heads % 2 == 0 else 5,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_heads % 2 == 0 else 1,
            head_dim=32 if self.head_dim != 256 else 64,
            d_ff=256,
            vocab_size=512,
            dtype="float32",
            moe_group=64,
        )
        if self.family == "moe":
            updates.update(n_experts=min(self.n_experts, 8),
                           moe_top_k=min(self.moe_top_k, 2),
                           d_ff_expert=64,
                           d_ff_shared=128 if self.d_ff_shared else 0)
        if self.family == "ssm":
            updates.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32,
                           n_heads=1, n_kv_heads=1)
        if self.family == "hybrid":
            updates.update(lru_width=128, window=64, n_layers=3,
                           n_heads=4, n_kv_heads=1, head_dim=32)
        if self.family == "encdec":
            updates.update(n_enc_layers=2, n_dec_layers=2, cross_len=32,
                           n_heads=4, n_kv_heads=4, head_dim=32)
        if self.family == "vlm":
            updates.update(n_image_tokens=8, n_kv_heads=2)
        if self.attn_kind == "mla":
            updates.update(kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
                           v_head_dim=32,
                           q_lora_rank=16 if self.q_lora_rank else 0)
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524288, 1),
}
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell_is_runnable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic decode (assignment brief)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention arch — a 524288-token dense "
                       "KV cache cannot be decoded sub-quadratically (DESIGN.md §5)")
    return True, ""
