"""deepseek-v2-lite [moe + MLA] — the first `attn_kind='mla'` arch.
[hf:deepseek-ai/DeepSeek-V2-Lite; arXiv:2405.04434]

27L d_model=2048 16H, MLA latent-KV: kv_lora_rank=512, qk 128 nope + 64
rope, v_head_dim=128 — so the cache holds ONE 576-wide latent row per token
(1152 B/token/layer bf16) instead of 16 K+V head pairs (131072 B: a 113×
shrink before int8 even enters). V2-Lite keeps the direct query projection
(q_lora_rank=0; the 236B V2 uses q_lora_rank=1536). MoE: 64 routed top-6 +
2 shared experts (2×1408 = 2816), first layer dense in the real model —
simplified here to all-MoE like the other moe archs.

`smoke()` scales the MLA dims down with the rest (base.ArchConfig.smoke),
keeping attn_kind='mla' so CPU tests exercise the latent path end to end.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    d_ff_expert=1408,
    d_ff_shared=2816,
    vocab_size=102400,
    n_experts=64,
    moe_top_k=6,
    activation="swiglu",
    rope_theta=1e4,
    attn_kind="mla",
    q_lora_rank=0,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)
