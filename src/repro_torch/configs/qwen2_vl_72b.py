"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

M-RoPE (3-section rotary: temporal/height/width), dynamic resolution
[arXiv:2409.12191].  The vision tower is a stub: ``input_specs()``
provides precomputed patch embeddings plus 3D M-RoPE position ids.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="dense",
    modality="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),   # temporal/height/width halves of hd=128
    norm_eps=1e-6,
    source="arXiv:2409.12191; hf",
)
