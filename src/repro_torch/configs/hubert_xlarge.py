"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only transformer, same backbone as wav2vec2 [arXiv:2106.07447].
The convolutional audio frontend is a stub: ``input_specs()`` provides
precomputed frame embeddings (batch, frames, d_model).  Training objective
is masked-frame prediction over the 504 cluster codebook.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    modality="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    rope_theta=0.0,          # learned/conv positions in the original; stubbed
    norm_eps=1e-5,
    source="arXiv:2106.07447; unverified",
)
