"""GQA attention: prefill over a whole prompt and decode against the cache.

Every attention function goes through :mod:`repro_torch.kernels.ops`,
so on the card the model runs the port's hand-written kernels (the JAX
package's model path called XLA mirrors instead; its Pallas kernels
were reached only from tests).  Layouts at the function boundaries are
the JAX package's: q ``(B, S, H, hd)``, caches ``(B, S, K, hd)``, pools
``(N, bl, K, hd)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
                      *, mask_pos: Optional[torch.Tensor] = None,
                      **kw) -> torch.Tensor:
    """Prefill attention (post-RoPE q/k) through
    :func:`repro_torch.kernels.ops.flash_attention`, keywords and all.
    Without ``mask_pos`` the mask is by row index, rows ``0..S-1``;
    ``mask_pos`` ``(B, S)`` masks by those positions instead, as the
    reference masks by M-RoPE's temporal stream
    (``src/repro/models/attention.py:41-55``): two rows with one id see
    each other whatever their order.  On the card that is the flash
    kernels' positions variant (the model passes ``mask_pos`` only where
    it is not the row index, so the index path runs as it did)."""
    return ops.flash_attention(q, k, v, positions=mask_pos, **kw)


def attention_tail(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   **kw) -> torch.Tensor:
    """Prefill attention for a prompt's tail: post-RoPE q ``(B, T, H,
    hd)`` at absolute positions ``M..M+T-1`` over k/v ``(B, M+T, K, hd)``
    (the resident prefix's rows, then the tail's).  The same route as
    :func:`attention_chunked`: :func:`repro_torch.kernels.ops
    .flash_attention`, whose queries are the key stream's last ``T``
    positions, so on the card the flash kernel runs at the offset and
    never falls back to the plain version."""
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


def attention_decode_split(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           block_tbl: Optional[torch.Tensor] = None, *,
                           cache_len, head_dim: int, reduce,
                           window: int = 0, mode: str = "auto"
                           ) -> torch.Tensor:
    """One-token decode over a cache split on head_dim: q ``(B, 1, H,
    DS)`` is this rank's columns of every query head and the dense ``(B,
    S, K, DS)`` cache (or ``(N, bl, K, DS)`` pool through ``block_tbl``)
    its columns of every row.  K9's pass 1
    (:func:`repro_torch.kernels.ops.decode_split_scores`) scores the
    columns at the whole ``head_dim``'s scale into the compact fp32
    ``(B, H, Wc)`` buffer (each slot's live rows only, ``Wc`` the window
    where there is one), ``reduce`` sums it over the ranks in place (the
    reference's psum of the score tensor,
    ``src/repro/models/lm.py:697-713``), and pass 2
    (:func:`~repro_torch.kernels.ops.decode_split_context`) applies the
    masked softmax to the rank's V columns: the context's ``(B, 1, H,
    DS)`` columns."""
    kw = dict(cache_len=cache_len, window=window, mode=mode)
    s = ops.decode_split_scores(q[:, 0].contiguous(), k_cache, block_tbl,
                                scale=head_dim ** -0.5, **kw)
    reduce(s)
    return ops.decode_split_context(s, v_cache, block_tbl, **kw)[:, None]


def project_qkv(x: torch.Tensor, p: AttnParams, n_heads: int, n_kv: int,
                hd: int, positions: torch.Tensor, theta: float,
                mrope_sections: Optional[Tuple[int, int, int]] = None,
                qk_norm_eps: float = 1e-6, proj=None):
    """q/k/v of ``x`` ``(B, S, d)``: projections, qk-norm, RoPE (M-RoPE
    over ``(3, B, S)`` positions with ``mrope_sections``).  ``proj(x,
    w)`` replaces the products ``x @ w`` (a mesh joins a split
    projection's columns there)."""
    lead = x.shape[:-1]
    proj = proj or torch.matmul
    q = proj(x, p.wq).reshape(*lead, n_heads, hd)
    k = proj(x, p.wk).reshape(*lead, n_kv, hd)
    v = proj(x, p.wv).reshape(*lead, n_kv, hd)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, qk_norm_eps)
        k = rms_norm(k, p.k_norm, qk_norm_eps)
    q = apply_rope(q, positions, theta, mrope_sections)
    k = apply_rope(k, positions, theta, mrope_sections)
    return q, k, v
