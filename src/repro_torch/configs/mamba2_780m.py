"""mamba2-780m [ssm] — SSD (state-space duality). [arXiv:2405.21060; unverified]

48L d_model=1536, attention-free, d_ff=0, vocab=50280, ssm_state=128.
d_inner = 2·d = 3072, head_dim 64 → 48 SSD heads (48/16 = 3 on `model`).
Decode is an O(1) state update → runs the long_500k cell.
vocab 50280 is padded to 50432 (×256) for even 16-way sharding.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,            # attn-free; SSD heads derive from d_inner/ssm_head_dim
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_kernel=4,
    tie_embeddings=True,
)
