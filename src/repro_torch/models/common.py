"""Shared model components: norms, rotary embeddings, initializers.

Numerics follow the JAX package (``repro/models/common.py``): bf16
streams, fp32 inside norms and rotary tables.  Two details matter for
parity: :func:`rms_norm` scales by ``1 + scale`` (norm weights are
initialized to zero), and RoPE is the half-split form (the first and
second halves of head_dim are the rotated pair), not interleaved.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotary embedding.

    ``x`` is ``(..., seq, heads, head_dim)``, ``positions`` ``(..., seq)``
    integer positions.  Angles, sin and cos are fp32; the result is cast
    back to ``x``'s dtype.
    """
    if theta <= 0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    inv = rope_frequencies(hd, theta, device=x.device)
    angles = positions.float()[..., None] * inv              # (..., seq, half)
    angles = angles[..., None, :]                            # (..., seq, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def truncated_normal_(t: torch.Tensor, scale: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with ``scale * N(0, 1)`` truncated to two
    standard deviations (the JAX package's ``truncated_normal_init``
    distribution), drawn in fp32 from ``generator`` and cast to
    ``t``'s dtype.  Large tensors are filled in slices along dim 0 so
    the fp32 staging buffer stays bounded."""
    rows = t.shape[0] if t.dim() else 1
    per_row = max(1, t.numel() // max(rows, 1))
    step = max(1, (1 << 26) // per_row)
    flat = t.view(rows, -1) if t.dim() else t.view(1, 1)
    for i in range(0, rows, step):
        buf = torch.empty(flat[i:i + step].shape, dtype=torch.float32,
                          device=t.device)
        torch.nn.init.trunc_normal_(buf, mean=0.0, std=scale,
                                    a=-2.0 * scale, b=2.0 * scale,
                                    generator=generator)
        flat[i:i + step].copy_(buf)
    return t
