"""chatglm3-6b [dense] — RoPE 2d (partial rotary), GQA kv=2. [arXiv:2406.12793; hf]

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024, head_dim=128.
ChatGLM applies rotary to half of each head dim (rope_fraction=0.5); the
other half passes through unrotated.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    activation="swiglu",
    qkv_bias=True,
    rope_fraction=0.5,
    rope_theta=1e4,
)
