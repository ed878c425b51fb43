"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512,
vocab=49155, MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base].
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    experts_per_token=8,
    moe_d_ff=512,
    moe_interleave=1,
    tie_embeddings=True,
    rope_theta=1e4,
    norm_eps=1e-6,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
