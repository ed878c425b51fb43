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

Tiles and splits: both kernels split each slot's cache rows across
CTAs.  :func:`decode_split` turns the plan's ``decode_attention``
BlockPlan tile (``block_kv``, else :data:`DEFAULT_BLOCK_KV`) into the
split size: every split covers a whole number of tiles, and there are
enough splits that the grid fills the card twice over where the
capacity allows.  The rule reads B, K and the cache's capacity, never
``cache_len`` (device memory: reading it would sync every tick).  Inside
a split each warp streams its rows through a ``cp.async`` ring of its
own, each row looking up its own block, so the tile is independent of
the pool's block length (the plan picks block lengths from 16 to 512).
Tiles outside :data:`KERNEL_TILES` raise.  :func:`decode_attention_splits`
mirrors the kernels' split-and-merge arithmetic in plain PyTorch for the
tests; nothing on the main path calls it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import build

KERNEL_TILES = (64, 128, 256)
DEFAULT_BLOCK_KV = 256
#: (GQA group, head_dim) pairs the kernels are instantiated for (``csrc``
#: ``REPRO_DECODE_CASE``): the powers of two up to 8, deepseek-coder-33b's
#: 7 and llama4-maverick's 5 at head_dim 128, hymba-1.5b's 5 and
#: granite-moe-1b-a400m's 2 at 64.  The template reads G only as a loop
#: bound and an array size, so a pair is one more instance
INSTANCES = ((1, 128), (2, 128), (4, 128), (7, 128), (8, 128), (5, 64),
             (2, 64), (5, 128))
#: the card's SMs; the split rule aims at two CTAs for each
SMS = 132
SPLIT_CTAS = 2 * SMS
MAX_SPLITS = 1024
#: ``csrc`` decode_kernel: warps a CTA, rows a warp stages per step, and
#: the depth of each warp's ``cp.async`` ring
WARPS, WARP_ROWS, STAGES = 4, 16, 2

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


def smem_bytes(G: int, tile: int, head_dim: int = 128) -> int:
    """Shared memory one CTA uses (``csrc`` ``Smem<G, D>::kBytes``): the
    warps' K/V rings (K rows padded by 16 bytes), reused after the row
    loop to merge the warps' partials, then the scaled q and each warp's
    probabilities.  The tile sets only the split size, not the ring."""
    D = head_dim
    ring = WARPS * STAGES * WARP_ROWS * (2 * D + 8) * 2
    merge = WARPS * G * (D + 2) * 4
    return max(ring, merge) + G * D * 4 + WARPS * WARP_ROWS * G * 4


def decode_split(B: int, K: int, capacity: int, tile: int
                 ) -> Tuple[int, int]:
    """``(splits, split_rows)`` of a launch: split ``s`` covers the rows
    ``[s * split_rows, (s + 1) * split_rows)`` of every slot.  Splits are
    whole tiles, at least one, and as many as it takes for ``B * K *
    splits`` to reach :data:`SPLIT_CTAS` where the capacity has that many
    tiles, and at most :data:`MAX_SPLITS` (the merge keeps a weight per
    split and head in shared memory).  It reads no ``cache_len``: the
    grid is the same for every length, and a split with no live row
    exits at once."""
    tiles = -(-capacity // tile)
    want = -(-SPLIT_CTAS // max(1, B * K))
    rows = tile * max(1, tiles // want, -(-tiles // MAX_SPLITS))
    return -(-capacity // rows), rows


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


def decode_attention_splits(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, cache_len: IntOrTensor,
                            split_rows: int, window: int = 0,
                            drop_split: int = -1) -> torch.Tensor:
    """The kernels' split-and-merge arithmetic in plain fp32 PyTorch, over
    a dense ``(B, S, K, D)`` cache (a paged one through its gathered
    view): split ``s``'s partial ``(m, l, acc)`` over its live rows, an
    empty split as ``m = -inf, l = 0``, merged in split order with empty
    partials absent; ``drop_split`` leaves one split out (the planted
    fault).  The tests hold it against the one-softmax plain versions;
    nothing on the main path calls it."""
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    cl = _lengths(cache_len, B, q.device).long().clamp(max=S)[:, None]
    lo = (cl - window).clamp_min(0) if window > 0 else torch.zeros_like(cl)
    kpos = torch.arange(S, device=q.device)[None, :]
    live = (kpos < cl) & (kpos >= lo)                          # (B, S)
    s = torch.einsum("bkgd,bskd->bkgs",
                     q.reshape(B, K, H // K, D).float() * (D ** -0.5),
                     k.float())
    parts = []
    for i in range(-(-S // split_rows)):
        ok = (live & (kpos >= i * split_rows)
              & (kpos < (i + 1) * split_rows))[:, None, None, :]
        sc = torch.where(ok, s, float("-inf"))
        m = sc.amax(-1)                                        # (B, K, G)
        p = torch.where(ok, torch.exp(sc - m[..., None]), 0.0)
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgs,bskd->bkgd", p, v.float())))
    kept = [x for i, x in enumerate(parts) if i != drop_split]
    m_all = torch.stack([m for m, _, _ in kept]).amax(0)
    acc = torch.zeros_like(kept[0][2])
    lsum = torch.zeros_like(kept[0][1])
    for m, l, a in kept:
        f = torch.where(m == float("-inf"), 0.0, torch.exp(m - m_all))
        acc = acc + f[..., None] * a
        lsum = lsum + f * l
    o = torch.where(lsum[..., None] > 0,
                    acc / lsum.clamp_min(1e-30)[..., None], 0.0)
    return o.reshape(B, H, D).to(q.dtype)


#: per-device arrival counters of the kernels' in-launch merge
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The ``(slot, kv head)`` arrival counters: zeroed once per device
    (again only when a launch needs more of them) and left at zero by
    every launch, so a call adds no memset.  Launches that share them
    must be ordered: the port launches on the current stream."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


def _workspace(q: torch.Tensor, K: int, splits: int) -> torch.Tensor:
    B, H, D = q.shape
    return torch.empty(B * K * splits * (H // K) * (D + 2),
                       dtype=torch.float32, device=q.device)


def takes_group(G: int, D: int) -> bool:
    """The decode kernels' admission rule for ``G`` query heads per kv
    head at head_dim ``D``: ``(G, D)`` is one of :data:`INSTANCES` (one
    template instance each)."""
    return (G, D) in INSTANCES


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
    if H % K or not takes_group(H // K, D):
        raise ValueError(f"{name}: kernel takes (GQA group, head_dim) in "
                         f"{INSTANCES}, got D={D} H={H} K={K}")


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
                           block_kv: Optional[int] = None,
                           drop_split: int = -1) -> torch.Tensor:
    """Launch the paged decode kernel on CUDA tensors (raises on any
    other device or on inputs the kernel does not take).  ``drop_split``
    plants a fault for the checks: that split is left out of the
    merge."""
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
    nb = block_tbl.shape[1]
    splits, rows = decode_split(B, K, nb * bl, tile)
    out = torch.empty_like(q)
    ws = _workspace(q, K, splits)
    err = build.library("decode_attention").paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tbl.data_ptr(), cl.data_ptr(), out.data_ptr(), ws.data_ptr(),
        _counters(q.device, B * K).data_ptr(), B, H, K, D, bl, nb,
        int(window), splits, rows, float(D ** -0.5), int(drop_split),
        torch.cuda.current_stream(q.device).cuda_stream)
    _launch_error("paged_decode_attention", err)
    paged_launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     cache_len: IntOrTensor, window: int = 0,
                     block_kv: Optional[int] = None,
                     drop_split: int = -1) -> torch.Tensor:
    """Launch the dense decode kernel on CUDA tensors (raises on any
    other device or on inputs the kernel does not take).  ``drop_split``
    as in :func:`paged_decode_attention`."""
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
    splits, rows = decode_split(B, K, S, tile)
    out = torch.empty_like(q)
    ws = _workspace(q, K, splits)
    err = build.library("decode_attention").decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(),
        out.data_ptr(), ws.data_ptr(), _counters(q.device, B * K).data_ptr(),
        B, S, H, K, D, int(window), splits, rows, float(D ** -0.5),
        int(drop_split), torch.cuda.current_stream(q.device).cuda_stream)
    _launch_error("decode_attention", err)
    dense_launches += 1
    return out
