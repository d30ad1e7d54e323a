"""qwen2.5-32b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064, head_dim=128.
Largest dense arch: layer-stacked lax.scan keeps HLO size O(1) in depth.
40 heads not divisible by model=16 → heads replicated on `model`; TP comes
from d_ff (27648/16 = 1728) and vocab (152064/16 = 9504).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
)
