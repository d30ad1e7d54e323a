"""seamless-m4t-medium [audio] — enc-dec, multimodal. [arXiv:2308.11596; hf]

12L encoder + 12L decoder, d_model=1024 16H (kv=16) d_ff=4096 vocab=256206,
head_dim=64. The audio frontend is a STUB: `input_specs()` provides
precomputed frame embeddings (B, S, d_model) for the encoder. Decode shapes
grow the *decoder self-attention* cache to seq_len; cross-attention reads a
fixed-length (cross_len) encoder memory. vocab padded to 256256 (×256).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=24,            # 12 enc + 12 dec
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    activation="geglu",     # seamless uses GELU FFN; GLU variant keeps 3-matrix FFN uniform
    audio_frontend=True,
    cross_len=4096,
)
