"""One-token GQA decode attention: the Hopper kernels and their plain versions.

Replaces the Pallas TPU kernels in ``repro/kernels/decode_attention.py``:
``paged_decode_attention`` (body ``_paged_decode_kernel``) and
``decode_attention`` (body ``_decode_kernel``).  Both run from one CUDA
source, ``csrc/decode_attention.cu``, whose header says what bounds
them on the card (bytes) and how the design answers that.

Contracts (supersets of the Pallas ones):

* :func:`paged_decode_attention` — q ``(B, H, D)``, pools ``(N, bl, K,
  D)``, block table ``(B, nb)`` int32 with ``-1`` = unassigned,
  per-slot ``cache_len`` ``(B,)``.  Only the live blocks are read; a
  ``-1`` entry is never dereferenced and reads as zero rows (the oracle
  ``paged_gather_ref`` semantics), so a freed slot's output is zeros.
* :func:`decode_attention` — a dense ``(B, S, K, D)`` cache with
  per-slot ``(B,)`` lengths (Pallas took one scalar for the batch).

Both take a static per-call sliding ``window`` (0 = unlimited).  The
wrappers launch the kernels on CUDA tensors and raise on any other
device; :mod:`repro_torch.kernels.ops` sends a CPU tensor to the plain
version beside each (one masked softmax in fp32, no tiles).

Tiles: both kernels stage ``block_kv`` cache rows per step — the plan's
``decode_attention`` BlockPlan, else :data:`DEFAULT_BLOCK_KV`.  The paged
kernel looks up each staged row's block on its own, so its tile is
independent of the pool's block length (the plan picks block lengths from
16 to 512).  Tiles outside :data:`KERNEL_TILES` raise.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import build

KERNEL_TILES = (64, 128, 256)
DEFAULT_BLOCK_KV = 256
HEAD_DIM = 128
MAX_GROUP = 8

#: launches of each CUDA kernel in this process (reset by the caller)
paged_launches = 0
dense_launches = 0

IntOrTensor = Union[int, torch.Tensor]


def _lengths(cache_len: IntOrTensor, B: int, device) -> torch.Tensor:
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    return cl.reshape(-1).expand(B).contiguous() if cl.numel() == 1 \
        else cl.reshape(B)


def kernel_tile(name: str, block_kv: Optional[int]) -> int:
    """Rows a decode kernel stages per step: the plan's ``block_kv`` or
    the documented default.  Raises on a tile the kernel is not built
    for — never substitutes another."""
    tile = DEFAULT_BLOCK_KV if block_kv is None else int(block_kv)
    if tile not in KERNEL_TILES:
        raise ValueError(f"{name}: block_kv={tile} is not one of the "
                         f"kernel's tiles {KERNEL_TILES}")
    return tile


def smem_bytes(G: int, tile: int) -> int:
    """Shared memory one CTA uses (``csrc`` ``smem_bytes<G, TILE>``)."""
    return 2 * tile * (HEAD_DIM + 8) * 2 + G * HEAD_DIM * 4 + G * tile * 4 \
        + 3 * G * 4


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, cache_len: IntOrTensor, window: int = 0
                           ) -> torch.Tensor:
    """The dense kernel's function in plain PyTorch: one masked softmax
    over each slot's live rows ``[cache_len - window, cache_len)`` in
    fp32.  A slot with no live row outputs zeros."""
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    cl = _lengths(cache_len, B, q.device).long()[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    ok = kpos < cl
    if window > 0:
        ok &= kpos >= cl - window
    ok = ok[:, None, None, :]                                  # (B,1,1,S)
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, K, H // K, D).float(),
                     k.float()) * (D ** -0.5)
    s = torch.where(ok, s, float("-inf"))
    p = torch.where(ok, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, H, D).to(q.dtype)


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, block_tbl: torch.Tensor,
                                 *, cache_len: IntOrTensor, window: int = 0
                                 ) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch: the dense version
    over each slot's gathered view, ``-1`` table entries read as zero
    rows (so a freed slot, row ``-1`` and length 1, outputs zeros)."""
    tbl = block_tbl.long()
    live = (tbl >= 0)[..., None, None, None]

    def view(pool):
        g = torch.where(live, pool[tbl.clamp_min(0)], 0)     # (B,nb,bl,K,D)
        return g.reshape(tbl.shape[0], -1, *pool.shape[2:])

    return decode_attention_plain(q, view(k_pool), view(v_pool),
                                  cache_len=cache_len, window=window)


def _check(name: str, q, caches, ints) -> None:
    for tname, t in caches:
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {tname} is {t.dtype}; the kernel takes "
                            "bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} is not contiguous")
    for tname, t in ints:
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous int32 on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    B, H, D = q.shape
    K = caches[1][1].shape[2]
    if D != HEAD_DIM or H % K or H // K > MAX_GROUP \
            or (H // K) & (H // K - 1):
        raise ValueError(f"{name}: kernel takes head_dim {HEAD_DIM} and a "
                         f"power-of-two GQA group <= {MAX_GROUP}, got D={D} "
                         f"H={H} K={K}")


def _on_card(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got "
                         f"{q.device} (kernels.ops routes CPU tensors to the "
                         "plain version)")


def _launch_error(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tbl: torch.Tensor, *,
                           cache_len: IntOrTensor, window: int = 0,
                           block_kv: Optional[int] = None) -> torch.Tensor:
    """Launch the paged decode kernel on CUDA tensors (raises on any
    other device or on inputs the kernel does not take)."""
    global paged_launches
    _on_card("paged_decode_attention", q)
    tile = kernel_tile("paged_decode_attention", block_kv)
    B, H, D = q.shape
    N, bl, K = k_pool.shape[:3]
    cl = _lengths(cache_len, B, q.device)
    _check("paged_decode_attention", q,
           [("q", q), ("k_pool", k_pool), ("v_pool", v_pool)],
           [("block_tbl", block_tbl), ("cache_len", cl)])
    if v_pool.shape != k_pool.shape or k_pool.shape[3] != D \
            or block_tbl.shape[0] != B:
        raise ValueError(f"paged_decode_attention: shapes q {tuple(q.shape)} "
                         f"pool {tuple(k_pool.shape)} "
                         f"table {tuple(block_tbl.shape)}")
    out = torch.empty_like(q)
    err = build.library("decode_attention").paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tbl.data_ptr(), cl.data_ptr(), out.data_ptr(),
        B, H, K, D, bl, block_tbl.shape[1], int(window), tile,
        float(D ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    _launch_error("paged_decode_attention", err)
    paged_launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     cache_len: IntOrTensor, window: int = 0,
                     block_kv: Optional[int] = None) -> torch.Tensor:
    """Launch the dense decode kernel on CUDA tensors (raises on any
    other device or on inputs the kernel does not take)."""
    global dense_launches
    _on_card("decode_attention", q)
    tile = kernel_tile("decode_attention", block_kv)
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    cl = _lengths(cache_len, B, q.device)
    _check("decode_attention", q, [("q", q), ("k", k), ("v", v)],
           [("cache_len", cl)])
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    out = torch.empty_like(q)
    err = build.library("decode_attention").decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(),
        out.data_ptr(), B, S, H, K, D, int(window), tile, float(D ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _launch_error("decode_attention", err)
    dense_launches += 1
    return out
