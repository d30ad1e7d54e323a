"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

24L d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert) vocab=151936,
MoE 60e top-4 + shared expert of 4×1408 = 5632 (sigmoid-gated).
60 experts are not divisible by the 16-way model axis → expert dim is
replicated and TP comes from d_ff_expert (1408/16 = 88); documented
trade-off in DESIGN.md §5.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    d_ff_expert=1408,
    d_ff_shared=5632,
    vocab_size=151936,
    n_experts=60,
    moe_top_k=4,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
    capacity_factor=1.25,
)
