"""llava-next-mistral-7b [vlm] — anyres tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The modality frontend is a STUB per the assignment: `input_specs()` provides
precomputed patch embeddings (B, n_image_tokens, d_model) — anyres tiling of
up to 5 tiles × 576 patches = 2880 image tokens — which the backbone merges
into the leading token positions before the decoder stack.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    activation="swiglu",
    rope_theta=1e6,
    n_image_tokens=2880,
)
