"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676].

Hymba runs attention heads and SSM heads *in parallel* inside each block
and mixes their (normalized) outputs.  Three layers use global (full)
attention; the rest use sliding-window attention (window 1024) — which is
what makes the ``long_500k`` decode cell sub-quadratic-feasible.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    window=1024,
    global_every=16,         # layers 0, 16, 31 -> global (see models/lm.py)
    ssm_state=16,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_n_groups=1,
    rope_theta=1e4,
    norm_eps=1e-6,
    source="arXiv:2411.13676; hf",
)
