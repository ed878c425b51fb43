"""GQA attention: prefill over a whole prompt and decode against the cache.

Every attention function goes through :mod:`repro_torch.kernels.ops`,
so on the card the model runs the port's hand-written kernels (the JAX
package's model path called XLA mirrors instead; its Pallas kernels
were reached only from tests).  Layouts at the function boundaries are
the JAX package's: q ``(B, S, H, hd)``, caches ``(B, S, K, hd)``, pools
``(N, bl, K, hd)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rms_norm


class AttnParams(NamedTuple):
    """Separate q/k/v projections of one layer."""

    wq: torch.Tensor               # (d, H * hd)
    wk: torch.Tensor               # (d, K * hd)
    wv: torch.Tensor               # (d, K * hd)
    wo: torch.Tensor               # (H * hd, d)
    q_norm: Optional[torch.Tensor] = None   # (hd,) qwen3 qk-norm scales
    k_norm: Optional[torch.Tensor] = None


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      **kw) -> torch.Tensor:
    """Prefill attention over positions ``0..S-1`` (post-RoPE q/k):
    :func:`repro_torch.kernels.ops.flash_attention`, keywords and all."""
    return ops.flash_attention(q, k, v, **kw)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, **kw) -> torch.Tensor:
    """One-token decode, q ``(B, 1, H, hd)``, against a dense per-slot
    cache with per-slot ``cache_len`` ``(B,)``: keywords as
    :func:`repro_torch.kernels.ops.decode_attention`."""
    return ops.decode_attention(q[:, 0], k_cache, v_cache, **kw)[:, None]


def attention_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tbl: torch.Tensor,
                           **kw) -> torch.Tensor:
    """One-token decode, q ``(B, 1, H, hd)``, against one layer's paged
    pool through the block table (-1 = unassigned): keywords as
    :func:`repro_torch.kernels.ops.paged_decode_attention`."""
    return ops.paged_decode_attention(q[:, 0], k_pool, v_pool, block_tbl,
                                      **kw)[:, None]


def project_qkv(x: torch.Tensor, p: AttnParams, n_heads: int, n_kv: int,
                hd: int, positions: torch.Tensor, theta: float,
                qk_norm_eps: float = 1e-6):
    """q/k/v of ``x`` ``(B, S, d)``: projections, qk-norm, RoPE."""
    lead = x.shape[:-1]
    q = (x @ p.wq).reshape(*lead, n_heads, hd)
    k = (x @ p.wk).reshape(*lead, n_kv, hd)
    v = (x @ p.wv).reshape(*lead, n_kv, hd)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, qk_norm_eps)
        k = rms_norm(k, p.k_norm, qk_norm_eps)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v
