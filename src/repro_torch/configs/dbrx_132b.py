"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
Experts shard 1-per-chip-group over the 16-way `model` axis (EP) and FSDP
over `data` on d_model; the most representative cell for the paper's
"modular acceleration" thesis (experts ↔ chiplets, dispatch ↔ UCIe).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    d_ff_expert=10752,
    vocab_size=100352,
    n_experts=16,
    moe_top_k=4,
    activation="swiglu",
    rope_theta=5e5,
    capacity_factor=1.25,
)
