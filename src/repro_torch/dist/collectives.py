"""Compressed collectives: int8 block quantization with error feedback.

The port of ``repro/dist/collectives.py``.  The math contract:

* :func:`quantize_int8` is block-wise symmetric: per 128-element block
  the reconstruction error is at most ``amax_block / 254``;
* :func:`ef_compress` is unbiased over time: the residual carries what
  quantization dropped, so ``sum(delivered) + residual ==
  sum(inputs)``;
* :func:`compressed_psum` is a mean all-reduce over a process group
  whose gradient-sized payload is the *code sum*: every rank quantizes
  against a shared scale (one all-reduce MAX of the block amax), the
  codes are summed (one all-reduce SUM), and the sum dequantizes to the
  mean.  The local residual comes back for feedback;
* :func:`compressed_slice_sum` is the same shared-scale code sum over a
  stacked leading axis in one process.

Rounding is half to even on both packages (``torch.round``,
``jnp.round``), so the codes agree bit for bit.  Shared-scale code sums
overflow int16 past ``127 * n > 32767``: callers gate these paths to
reduction degrees <= 256.  The JAX package sums int16 codes on the wire;
gloo has no int16 reduction, so :func:`compressed_psum` carries the
codes as int32 there (twice the wire bytes, the same value).  The train
step's wire (``lowering.lower_train_step`` where ``wire_compression >
0``) reduces each leaf's ``g + e`` through :func:`compressed_psum`; a
plan that compresses without the wire runs :func:`ef_compress` on each
reduced gradient.

The mesh code's plain collectives live here too, over a list of
``(group, size)`` (one a mesh axis, data-major, size-1 axes left out:
:func:`axes_groups`), so several mesh axes act together one axis at a
time and no flattened group is ever created: :func:`sum_over_` (an
fp32 sum in place, a chunk at a time) and :func:`all_gather`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

#: quantization block: one fp32 scale per 128 values
BLOCK = 128
#: elements :func:`sum_over_` widens to fp32 at a time (64 MB)
CHUNK = 1 << 24


def axes_groups(mesh, axes) -> List[Tuple[object, int]]:
    """``(group, size)`` of each of ``axes`` on ``mesh``, in the mesh's
    (data-major) order, size-1 axes left out."""
    names = tuple(mesh.mesh_dim_names)
    return [(mesh.get_group(a), mesh.size(names.index(a)))
            for a in names if a in axes and mesh.size(names.index(a)) > 1]


def sum_over_(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` (contiguous) summed over ``groups`` in place: each chunk
    of :data:`CHUNK` elements widened to fp32, summed over each group in
    turn and rounded once to ``t``'s dtype, so no second copy of ``t``
    exists."""
    if not groups:
        return t
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        c = flat[i:i + CHUNK]
        s = c if c.dtype == torch.float32 else c.float()
        for g, _ in groups:
            dist.all_reduce(s, group=g)
        if s is not c:
            c.copy_(s)
    return t


def all_gather(t: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """The pieces of ``groups`` (data-major) joined along ``dim``, in
    rank order: the innermost axis first."""
    for g, n in reversed(list(groups)):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=g)
        t = torch.cat(parts, dim=dim)
    return t


def quantize_int8(x: torch.Tensor, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(q, scales, pad)``: int8 codes ``(nblocks, block)`` of the
    flattened ``x``, one fp32 scale a block, and the zero-padded tail."""
    flat = torch.as_tensor(x).to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = amax.clamp_min(1e-30) / 127.0
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0], pad


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, pad: int,
                    shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (fp32 of ``shape``)."""
    flat = (q.to(torch.float32) * scales[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def ef_compress(g: torch.Tensor, err: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compression of one gradient leaf: ``ghat = Q(g +
    err)`` and the new residual ``(g + err) - ghat`` (fp32 for a fresh
    one, else in ``err``'s dtype)."""
    g32 = g.to(torch.float32)
    acc = g32 if err is None else g32 + err.to(torch.float32)
    q, scales, pad = quantize_int8(acc)
    ghat = dequantize_int8(q, scales, pad, tuple(g.shape))
    new_err = (acc - ghat).to(torch.float32 if err is None else err.dtype)
    return ghat.to(g.dtype), new_err


def ef_state(params, replicas: int = 1):
    """Zero bf16 residuals, one per parameter leaf (a leading
    ``(replicas,)`` axis when ``replicas > 1``)."""
    if isinstance(params, dict):
        return {k: ef_state(v, replicas) for k, v in params.items()}
    shape = ((replicas,) if replicas > 1 else ()) + tuple(params.shape)
    return torch.zeros(shape, dtype=torch.bfloat16, device=params.device)


def _last_dim_blocks(x32: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(..., d)`` -> ``(..., nb, BLOCK)`` with zero tail padding (the
    last dim only, so leading dims stay intact)."""
    d = x32.shape[-1]
    pad = (-d) % BLOCK
    if pad:
        x32 = torch.nn.functional.pad(x32, (0, pad))
    return x32.reshape(*x32.shape[:-1], -1, BLOCK), pad


def _unblock(blocks: torch.Tensor, d: int, pad: int) -> torch.Tensor:
    flat = blocks.reshape(*blocks.shape[:-2], -1)
    return flat[..., :d] if pad else flat


def compressed_psum(x: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean all-reduce over ``group`` of int8-quantized values:
    ``(mean, err)``, ``err`` this rank's quantization residual.  Two
    collectives: MAX of the block amax, SUM of the codes (int32).
    ``group`` may be a list of ``(group, size)`` (:func:`axes_groups`):
    several mesh axes taken as one group, each collective run over each
    axis in turn (a MAX of MAXes, a SUM of SUMs)."""
    groups = group if isinstance(group, list) else [
        (group, dist.get_world_size(group))]
    x32 = torch.as_tensor(x).to(torch.float32)
    d = x32.shape[-1]
    blocks, pad = _last_dim_blocks(x32)
    amax = blocks.abs().amax(dim=-1)
    for g, _ in groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g)
    scale = amax.clamp_min(1e-30) / 127.0
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127.0, 127.0)
    n = 1
    for _, k in groups:
        n *= k
    qsum = q.to(torch.int32)
    for g, _ in groups:
        dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=g)
    y = _unblock(qsum.to(torch.float32) * scale[..., None], d, pad) / n
    err = x32 - _unblock(q * scale[..., None], d, pad)
    return y.to(x.dtype), err.to(x.dtype)


def compressed_slice_sum(stacked: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared-scale code-sum mean over a stacked ``(r, ...)`` axis:
    ``(mean, err)`` with ``err[i] == stacked[i] - dequant(codes[i])``
    exactly, so ``mean + mean_i(err[i]) == mean_i(stacked[i])``."""
    r = stacked.shape[0]
    a32 = torch.as_tensor(stacked).to(torch.float32)
    d = a32.shape[-1]
    blocks, pad = _last_dim_blocks(a32)
    amax = blocks.abs().amax(dim=-1).amax(dim=0)
    scale = amax.clamp_min(1e-30) / 127.0
    q = torch.clamp(torch.round(blocks / scale[None, ..., None]),
                    -127.0, 127.0)
    qsum = q.to(torch.int16).sum(dim=0, dtype=torch.int16)
    mean = _unblock(qsum.to(torch.float32) * scale[..., None], d, pad) / r
    err = a32 - _unblock(q * scale[None, ..., None], d, pad)
    return mean, err
