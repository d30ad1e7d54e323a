"""gemma-7b [dense] — GeGLU, head_dim=256. [arXiv:2403.08295; hf]

28L d_model=3072 16H (GQA kv=16, i.e. MHA on 7b; MQA is the 2b variant)
d_ff=24576 vocab=256000. Embeddings scaled by sqrt(d_model), tied lm head,
(1+w) RMSNorm. The 256k vocab makes the sharded-vocab chunked CE essential
(full logits at train_4k would be 256·4096·256000·2B ≈ 537 GB).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    rope_theta=1e4,
    tie_embeddings=True,
    embed_scale=True,
    norm_plus_one=True,
)
