"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152. head_dim = 960/15 = 64.
15 heads / 5 kv-heads are not divisible by the 16-way model axis → the
divisibility rule replicates head dims on `model` and TP comes from d_ff
(2560/16 = 160) and vocab (49152/16 = 3072). See DESIGN.md §6.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    activation="swiglu",
    rope_theta=1e4,
    tie_embeddings=True,
)
