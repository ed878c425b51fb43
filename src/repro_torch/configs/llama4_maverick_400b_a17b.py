"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, vocab=202048, MoE 128 experts top-1, early fusion.

Maverick interleaves MoE every other layer and adds one shared expert
(hf:meta-llama/Llama-4-*; unverified).  Dense layers use d_ff=16384
(2x expert dim) per the released config.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=16384,              # dense-layer FFN width
    vocab_size=202048,
    n_experts=128,
    experts_per_token=1,
    moe_d_ff=8192,
    moe_interleave=2,        # MoE every other layer
    n_shared_experts=1,
    rope_theta=5e5,
    norm_eps=1e-5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (scaled); unverified",
)
