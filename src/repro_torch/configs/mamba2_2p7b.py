"""mamba2-2.7b [ssm]: 64L d_model=2560, attention-free, vocab=50280,
ssm_state=128.  SSD (state-space duality) [arXiv:2405.21060].
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_n_groups=1,
    norm_eps=1e-5,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
