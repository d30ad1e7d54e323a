"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2. [arXiv:2402.19427; hf]

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, head_dim=256,
lru_width=2560, local-attention window 2048, pattern (rec, rec, attn).
Constant-size state (LRU h + 2048-token window cache) → runs long_500k.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    activation="geglu",
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    window=2048,
    rope_theta=1e4,
    tie_embeddings=True,
    embed_scale=True,
    norm_plus_one=True,
    logit_softcap=30.0,
)
