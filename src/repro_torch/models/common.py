"""Shared model components: norms, rotary embeddings, initializers.

Numerics follow the JAX package (``repro/models/common.py``): bf16
streams, fp32 inside norms and rotary tables.  Two details matter for
parity: :func:`rms_norm` scales by ``1 + scale`` (norm weights are
initialized to zero), and RoPE is the half-split form (the first and
second halves of head_dim are the rotated pair), not interleaved.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
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


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """Half-split rotary embedding; qwen2-vl's M-RoPE through three
    position streams.

    ``x`` is ``(..., seq, heads, head_dim)``, ``positions`` ``(..., seq)``
    integer positions, or, with ``mrope_sections``, ``(3, ..., seq)``:
    temporal, height and width ids.  The ``head_dim / 2`` frequency
    slots are split into the sections, each rotated by its own stream
    (``src/repro/models/common.py:31-66``).  Angles, sin and cos are
    fp32; the result is cast back to ``x``'s dtype.
    """
    if theta <= 0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    inv = rope_frequencies(hd, theta, device=x.device)
    if mrope_sections is not None:
        if sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not "
                             f"cover head_dim / 2 = {half}")
        # which of the three streams drives each frequency slot
        sel = torch.repeat_interleave(
            torch.arange(3, device=x.device),
            torch.tensor(mrope_sections, device=x.device))
        pos = positions.float().movedim(0, -1)               # (..., seq, 3)
        angles = pos[..., sel] * inv                         # (..., seq, half)
    else:
        angles = positions.float()[..., None] * inv          # (..., seq, half)
    angles = angles[..., None, :]                            # (..., seq, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """The fixed sinusoidal position table ``(seq, dim)``, fp32, that
    the audio frontend stub adds to hubert's frame embeddings
    (``src/repro/models/common.py:68-74``): computed in fp64 on
    ``device``, as numpy computes the reference's, then cast."""
    pos = torch.arange(seq, dtype=torch.float64, device=device)[:, None]
    i = torch.arange(dim, dtype=torch.float64, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * torch.div(i, 2, rounding_mode="floor")
                            / dim)
    table = torch.where(i % 2 == 0, torch.sin(angle), torch.cos(angle))
    return table.float()


#: elements of the fp32 staging buffer :func:`truncated_normal_` draws into
STAGING = 1 << 26


def truncated_normal_(t: torch.Tensor, scale: float,
                      generator: torch.Generator,
                      whole: Optional[Sequence[int]] = None,
                      start: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Fill ``t`` in place with ``scale * N(0, 1)`` truncated to two
    standard deviations (the JAX package's ``truncated_normal_init``
    distribution), drawn in fp32 from ``generator`` and cast to
    ``t``'s dtype.  Large tensors are filled in slices of whole rows,
    a row spanning the fewest leading dims whose rows hold at most
    :data:`STAGING` elements, so the fp32 staging buffer stays at or
    under that bound (an expert stack ``(1, E, d, 2 ff)`` is sliced
    over ``E`` and ``d``).  A tensor whose dim-0 rows fit is sliced
    along dim 0 alone.

    With ``whole`` and ``start``, ``t`` is the piece from index
    ``start`` (an offset a dim) of a ``whole``-shaped tensor: the whole
    is drawn in the same slices and ``t`` keeps the entries that fall in
    it, exactly those the whole would hold there, while no more than
    the piece and one slice are ever allocated."""
    shape = tuple(t.shape) if whole is None else tuple(whole)
    dim, numel = len(shape), math.prod(shape)
    lead, rows = 1, (shape[0] if dim else 1)
    while lead < dim and numel // max(rows, 1) > STAGING:
        lead += 1
        rows *= shape[lead - 1]
    per_row = max(1, numel // max(rows, 1))
    step = max(1, STAGING // per_row)
    if whole is None:
        flat = t.view(rows, -1) if dim else t.view(1, 1)
    else:
        tail = (slice(None),) + tuple(slice(a, a + n) for a, n in
                                      zip(start[lead:], t.shape[lead:]))
        local = t.view(-1, *t.shape[lead:])
    for i in range(0, rows, step):
        n = min(step, rows - i)
        buf = torch.empty((n, per_row), dtype=torch.float32, device=t.device)
        torch.nn.init.trunc_normal_(buf, mean=0.0, std=scale,
                                    a=-2.0 * scale, b=2.0 * scale,
                                    generator=generator)
        if whole is None:
            flat[i:i + n].copy_(buf)
            continue
        # the slice's rows that lie in the piece, and where they go
        idx = np.unravel_index(np.arange(i, i + n), shape[:lead])
        keep = np.ones(n, bool)
        for d in range(lead):
            keep &= (idx[d] >= start[d]) & (idx[d] < start[d] + t.shape[d])
        if not keep.any():
            continue
        at = np.ravel_multi_index(
            tuple(idx[d][keep] - start[d] for d in range(lead)),
            t.shape[:lead])
        mine = buf.view(n, *shape[lead:])[
            torch.as_tensor(np.nonzero(keep)[0], device=t.device)][tail]
        local[torch.as_tensor(at, device=t.device)] = mine.to(t.dtype)
    return t


#: the z-loss weight of every cross-entropy (``repro/models/common.py``)
Z_LOSS = 1e-4


def token_nll(logits: torch.Tensor, targets: torch.Tensor,
              vocab_size: Optional[int] = None, z_loss: float = Z_LOSS
              ) -> torch.Tensor:
    """Each token's cross-entropy with z-loss, fp32: the terms
    :func:`cross_entropy_loss` averages."""
    v = logits.shape[-1]
    logits = logits.float()
    if vocab_size is not None and vocab_size < v:
        slot = torch.arange(v, device=logits.device)
        logits = torch.where(slot < vocab_size, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = Z_LOSS,
                       vocab_size: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean cross-entropy with z-loss, in fp32
    (``repro/models/common.py:82``): ``(loss, n)``, ``n`` the count of
    tokens averaged over.  Logits past ``vocab_size`` (the layout pass's
    padded vocab) are masked to -1e30 before the log-sum-exp, as the
    reference masks them."""
    nll = token_nll(logits, targets, vocab_size, z_loss)
    if mask is not None:
        mask = mask.float()
        n = mask.sum().clamp_min(1.0)
        return (nll * mask).sum() / n, n
    return nll.mean(), torch.tensor(float(nll.numel()), device=nll.device)
