"""Flash attention (forward): the Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``, and the packed-causal grid
``_flash_causal_packed``).  The CUDA source is
``csrc/flash_attention.cu``; its header says what bounds it on the card
and how the design answers that.

Contract (a superset of the Pallas one): q ``(B, S, H, D)``, k/v
``(B, S, K, D)``, GQA with ``H % K == 0``, causal and sliding-window
masks, any ``S`` (the ragged edge is masked; Pallas asserted ``S % block
== 0``).  Output has q's dtype.  :func:`flash_attention` launches the
kernel on CUDA tensors and raises on any other device;
:mod:`repro_torch.kernels.ops` sends a CPU tensor to
:func:`flash_attention_plain` (one masked softmax in fp32, no tiles).

Tiles: the kernel's CTA holds ``rows = block_q * G`` query rows
(``block_q`` positions times the ``G = H/K`` heads sharing a kv head)
and stages ``block_kv`` K/V rows at a time.  It is built for ``(rows,
block_kv)`` in :data:`KERNEL_TILES`; :func:`kernel_tiles` raises on any
other plan tile.  A plan without a ``flash_attention`` BlockPlan (decode
shapes have none) gets :data:`DEFAULT_ROWS` x :data:`DEFAULT_BLOCK_KV`,
113 KB of shared memory, two CTAs to an SM.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

#: (query rows, kv rows) the CUDA kernel is instantiated for
KERNEL_TILES = ((64, 64), (64, 128), (128, 64))
DEFAULT_ROWS = 64
DEFAULT_BLOCK_KV = 64
HEAD_DIM = 128

#: launches of the CUDA kernel in this process (reset by the caller)
launches = 0


def smem_bytes(rows: int, block_kv: int) -> int:
    """Shared memory one CTA uses at a tile (``csrc`` ``Smem::total``)."""
    qp, op = HEAD_DIM + 8, HEAD_DIM + 4
    return (rows * qp * 2 + 2 * block_kv * qp * 2 + rows * (block_kv + 4) * 4
            + rows * (block_kv + 8) * 2 + rows * op * 4 + 2 * rows * 4)


def kernel_tiles(G: int, block_q: Optional[int] = None,
                 block_kv: Optional[int] = None) -> Tuple[int, int]:
    """``(rows, block_kv)`` for a GQA group of ``G`` heads: the plan's
    ``block_q`` positions x ``G``, or the documented default.  Raises
    on a tile the kernel cannot run — never substitutes another."""
    if block_q is None and block_kv is None:
        rows, bkv = DEFAULT_ROWS, DEFAULT_BLOCK_KV
        if rows % G:
            raise ValueError(
                f"flash_attention: default tile of {rows} query rows does "
                f"not hold whole GQA groups of {G} heads")
        return rows, bkv
    if block_q is None or block_kv is None:
        raise ValueError("flash_attention: give both block_q and block_kv")
    rows = block_q * G
    if (rows, block_kv) not in KERNEL_TILES:
        raise ValueError(
            f"flash_attention: tile block_q={block_q} x G={G} = {rows} rows, "
            f"block_kv={block_kv} is not one the kernel is built for "
            f"{KERNEL_TILES}")
    return rows, block_kv


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: one masked softmax over
    all key positions in fp32, the same superset contract (any ``S``).
    Runs on any device."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= (qpos - kpos) < window
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(B, S, K, H // K, D).float(),
                     k.float()) * (D ** -0.5)
    p = torch.softmax(torch.where(ok, s, float("-inf")), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            "kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if D != HEAD_DIM or H % k.shape[2]:
        raise ValueError(f"flash_attention: kernel takes head_dim "
                         f"{HEAD_DIM} and H % K == 0, got D={D} H={H} "
                         f"K={k.shape[2]}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: Optional[int] = None,
                    block_kv: Optional[int] = None) -> torch.Tensor:
    """Launch the GQA flash kernel on CUDA tensors (raises on any other
    device or on inputs the kernel does not take)."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: the kernel runs on CUDA tensors, "
                         f"got {q.device} (kernels.ops routes CPU tensors to "
                         "the plain version)")
    _check(q, k, v)
    B, S, H, D = q.shape
    K = k.shape[2]
    rows, bkv = kernel_tiles(H // K, block_q, block_kv)
    out = torch.empty_like(q)
    err = build.library("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, H, K, D, int(causal), int(window), rows, bkv,
        float(D ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd: launch failed with "
                           f"cudaError {err}")
    launches += 1
    return out
