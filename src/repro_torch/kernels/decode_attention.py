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

Per-shard partials (K8): where a mesh shards the cache's rows over
ranks (:mod:`repro_torch.dist.flash_decode`), each rank needs the
unnormalised online-softmax terms ``(m, l, acc)`` of its own rows, and
the ranks combine them.  :func:`decode_partial` (a dense slice whose
first row is the global row ``kv_start``) and
:func:`paged_decode_partial` (a sub-pool whose first block is the
global block ``block_start``, read through the global table) launch the
same kernels in their ``PARTIAL`` mode: the last CTA of a (slot, kv
head) writes the merged fp32 ``m`` and ``l`` ``(B, H)`` and ``acc``
``(B, H, D)`` instead of the bf16 output.  A row is live where its
global position lies in ``[pos + 1 - window, pos]`` (from 0 without a
window) and, paged, its block is owned and assigned; unowned blocks are
never read.  Their plain versions, :func:`decode_partial_plain` and
:func:`paged_decode_partial_plain`, are the JAX package's
``_partial_attend`` and ``_partial_attend_paged``: a masked row scores
:data:`NEG_INF`, so a shard without a live row gives ``m = NEG_INF``,
``l`` = its row count, where the kernel gives ``m = -inf, l = 0``.  The
combined context is the same wherever some shard of the slot has a
live row.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import build

KERNEL_TILES = (64, 128, 256)
DEFAULT_BLOCK_KV = 256
#: (GQA group, head_dim) pairs the kernels are instantiated for (``csrc``
#: ``REPRO_DECODE_CASE``): the powers of two up to 8, deepseek-coder-33b's
#: 7 and llama4-maverick's 5 at head_dim 128, hymba-1.5b's 5 and
#: granite-moe-1b-a400m's 2 at 64; on a 16-wide model axis the padded
#: llama4-maverick's 6 at 128 (48 / 8 heads) and hymba-1.5b's 4 at 64
#: (32 / 8), which the sharded decode runs over every head.  The template
#: reads G only as a loop bound and an array size, so a pair is one more
#: instance
INSTANCES = ((1, 128), (2, 128), (4, 128), (7, 128), (8, 128), (5, 64),
             (2, 64), (5, 128), (6, 128), (4, 64))
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
partial_launches = 0
paged_partial_launches = 0
#: the masked score of the plain partials (the JAX package's value)
NEG_INF = -1e30

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


# ---------------------------------------------------------------------
# work: (flops, bytes) of one call, and the fake path
# ---------------------------------------------------------------------

def work(B: int, H: int, K: int, D: int, lens: Sequence[int], *,
         window: int = 0, block_len: int = 0,
         itemsize: int = 2) -> Tuple[float, float]:
    """``(flops, bytes)`` of one dense (``block_len`` 0) or paged decode
    call over slots of cache lengths ``lens``: 4 D a live row a query
    head, and q read and the output written once, the int32 lengths,
    each live K/V row read once and, paged, each table entry those rows
    lie in (4 bytes).  A window keeps each slot's last ``window``
    rows."""
    rows = [min(n, window) if window else n for n in lens]
    live = sum(rows)
    nbytes = itemsize * 2 * B * H * D + 4 * B + itemsize * 2 * live * K * D
    if block_len:
        nbytes += 4 * sum(-(-n // block_len) for n in rows)
    return 4.0 * D * H * live, float(nbytes)


def partial_work(B: int, H: int, K: int, D: int, rows: int,
                 itemsize: int = 2) -> Tuple[float, float]:
    """``(flops, bytes)`` of one per-shard partial (K8) over ``rows``
    live rows of the shard, summed over the slots: 4 D a row a query
    head; q and the lengths read, the fp32 ``(m, l, acc)`` written, each
    live K/V row read once."""
    nbytes = rows * K * D * itemsize * 2 + B * H * D * itemsize \
        + B * H * (D + 2) * 4 + B * 4
    return 4.0 * rows * H * D, float(nbytes)


def split_scores_work(B: int, H: int, K: int, DS: int, live: int
                      ) -> Tuple[float, float]:
    """``(flops, bytes)`` of K9's pass 1 over ``live`` rows (summed over
    the slots): 2 DS a row a query head; the slice's live K rows and q
    read, each live fp32 score written once, the lengths read."""
    nbytes = live * K * DS * 2 + B * H * DS * 2 + live * H * 4 + B * 4
    return 2.0 * live * H * DS, float(nbytes)


def split_context_work(B: int, H: int, K: int, DS: int, live: int
                       ) -> Tuple[float, float]:
    """``(flops, bytes)`` of K9's pass 2: 2 DS a live row a query head;
    the live V rows and scores read, the context's columns written."""
    nbytes = live * K * DS * 2 + live * H * 4 + B * H * DS * 2 + B * 4
    return 2.0 * live * H * DS, float(nbytes)


def _fake_lens(cache_len, B: int, capacity: int, window: int) -> List[int]:
    from repro_torch.kernels import fake
    return [min(n, window) if window else n
            for n in fake.lengths(cache_len, B, capacity)]


def decode_fake(q: torch.Tensor, k: torch.Tensor,
                block_tbl: Optional[torch.Tensor] = None, *,
                cache_len: IntOrTensor, window: int = 0) -> torch.Tensor:
    """The decode kernels' fake path (:mod:`repro_torch.kernels.fake`):
    the output ``(B, H, D)``, the call's :func:`work` recorded under
    ``decode_attention`` or ``paged_decode_attention``; a length that
    cannot be read counts the whole cache (a paged slot: its table
    row's blocks).  Raises where the launch would (:func:`admit`)."""
    from repro_torch.kernels import fake
    B, H, D = q.shape
    if block_tbl is None:
        name, bl, cap = "decode_attention", 0, k.shape[1]
    else:
        name, bl = "paged_decode_attention", k.shape[1]
        cap = block_tbl.shape[1] * bl
    admit(name, H, k.shape[2], D)
    lens = fake.lengths(cache_len, B, cap)
    fake.record(name, work(B, H, k.shape[2], D, lens, window=window,
                           block_len=bl, itemsize=k.element_size()))
    return torch.empty_like(q)


def partial_fake(q: torch.Tensor, k: torch.Tensor,
                 block_tbl: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's fake path: ``(m, l, acc)`` in fp32, :func:`partial_work`
    over every row the shard could hold for each slot (a dense slice's
    rows; a sub-pool's ``min(table width, blocks)`` blocks).  Raises
    where the launch would (:func:`admit`)."""
    from repro_torch.kernels import fake
    B, H, D = q.shape
    if block_tbl is None:
        name, rows = "decode_partial", B * k.shape[1]
    else:
        name = "paged_decode_partial"
        rows = B * min(block_tbl.shape[1], k.shape[0]) * k.shape[1]
    admit(name, H, k.shape[2], D)
    fake.record(name, partial_work(B, H, k.shape[2], D, rows,
                                   k.element_size()))
    m = q.new_empty((B, H), dtype=torch.float32)
    return m, torch.empty_like(m), q.new_empty((B, H, D),
                                               dtype=torch.float32)


def split_scores_fake(q: torch.Tensor, k: torch.Tensor,
                      block_tbl: Optional[torch.Tensor] = None, *,
                      cache_len: IntOrTensor, window: int = 0
                      ) -> torch.Tensor:
    """K9 pass 1's fake path: the compact ``(B, H, Wc)`` fp32 scores,
    :func:`split_scores_work` over the live rows (the whole view where
    the lengths cannot be read).  Raises where the launch would
    (:func:`admit_split`)."""
    from repro_torch.kernels import fake
    B, H, DS = q.shape
    admit_split("decode_split_scores", H, k.shape[2], DS)
    cap = k.shape[1] if block_tbl is None \
        else block_tbl.shape[1] * k.shape[1]
    live = sum(_fake_lens(cache_len, B, cap, window))
    fake.record("decode_split_scores",
                split_scores_work(B, H, k.shape[2], DS, live))
    return q.new_empty((B, H, split_cols(cap, window)), dtype=torch.float32)


def split_context_fake(s: torch.Tensor, v: torch.Tensor,
                       block_tbl: Optional[torch.Tensor] = None, *,
                       cache_len: IntOrTensor, window: int = 0
                       ) -> torch.Tensor:
    """K9 pass 2's fake path: the context's ``(B, H, DS)`` columns in
    V's dtype, :func:`split_context_work` recorded; raises where the
    launch would (:func:`admit_split`)."""
    from repro_torch.kernels import fake
    B, H, _ = s.shape
    K, DS = v.shape[2], v.shape[3]
    admit_split("decode_split_context", H, K, DS)
    cap = v.shape[1] if block_tbl is None \
        else block_tbl.shape[1] * v.shape[1]
    live = sum(_fake_lens(cache_len, B, cap, window))
    fake.record("decode_split_context",
                split_context_work(B, H, K, DS, live))
    return v.new_empty((B, H, DS))


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


def _partial_terms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kpos: torch.Tensor, pos: torch.Tensor, window: int,
                   extra: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_partial_attend`` of the JAX package in fp32: q ``(B, H, D)``,
    k/v ``(B, S, K, D)``, ``kpos`` the rows' global positions ``(S,)``
    or ``(B, S)``, ``pos`` ``(B,)``; ``extra`` ``(B, S)`` masks more
    rows.  Returns ``m``, ``l`` ``(B, H)`` and ``acc`` ``(B, H, D)``."""
    B, H, D = q.shape
    K = k.shape[2]
    qh = q.reshape(B, K, H // K, D).float() * (D ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qh, k.float())
    kpos = kpos if kpos.dim() == 2 else kpos[None, :]
    pos = pos.long()[:, None]
    valid = kpos <= pos
    if window > 0:
        valid &= (pos - kpos) < window
    if extra is not None:
        valid &= extra
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return m.reshape(B, H), p.sum(-1).reshape(B, H), acc.reshape(B, H, D)


def decode_partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, kv_start: int, pos: torch.Tensor,
                         window: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense partial: a ``(B, Sl, K, D)`` slice of the cache whose
    row ``r`` is the global row ``kv_start + r``, per-slot ``pos``."""
    kpos = kv_start + torch.arange(k.shape[1], device=q.device)
    return _partial_terms(q, k, v, kpos, pos, window)


def paged_decode_partial_plain(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, block_tbl: torch.Tensor,
                               *, block_start: int, pos: torch.Tensor,
                               window: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The paged partial over the blocks of a ``(Nl, bl, K, D)``
    sub-pool whose first block is the global block ``block_start``,
    through the global ``(B, nb)`` table.  As the JAX package's
    ``_partial_attend_paged``, each slot's owned columns are first
    moved to the front (stable), and only ``min(nb, Nl)`` of them are
    gathered; a row keeps the position of its table column."""
    Nl, bl = k_pool.shape[0], k_pool.shape[1]
    B, nb = block_tbl.shape
    tbl = block_tbl.long()
    loc = tbl - block_start
    owned = (tbl >= 0) & (loc >= 0) & (loc < Nl)
    cols = min(nb, Nl)
    if cols < nb:
        order = torch.argsort((~owned).to(torch.int8), dim=1,
                              stable=True)[:, :cols]
        loc = torch.gather(loc, 1, order)
        owned = torch.gather(owned, 1, order)
        blk_pos = order
    else:
        blk_pos = torch.arange(nb, device=q.device).expand(B, nb)
    safe = loc.clamp(0, Nl - 1)
    kd = k_pool[safe].reshape(B, cols * bl, *k_pool.shape[2:])
    vd = v_pool[safe].reshape(B, cols * bl, *v_pool.shape[2:])
    kpos = (blk_pos[:, :, None] * bl
            + torch.arange(bl, device=q.device)[None, None, :]
            ).reshape(B, cols * bl)
    extra = owned.repeat_interleave(bl, dim=1)
    return _partial_terms(q, kd, vd, kpos, pos, window, extra)


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


def admit(name: str, H: int, K: int, D: int) -> None:
    """Raise where the decode kernels (and K8) have no instance for
    ``H`` query heads over ``K`` kv heads at head_dim ``D``: the rule
    every launch and every fake call applies."""
    if H % K or not takes_group(H // K, D):
        raise ValueError(f"{name}: kernel takes (GQA group, head_dim) in "
                         f"{INSTANCES}, got D={D} H={H} K={K}")


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
    admit(name, H, caches[1][1].shape[2], D)


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


def _partial_out(q: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """One fp32 buffer for a partial's ``m``, ``l`` ``(B, H)`` and
    ``acc`` ``(B, H, D)``, and the three views of it."""
    B, H, D = q.shape
    buf = torch.empty(B * H * (D + 2), dtype=torch.float32, device=q.device)
    return (buf, buf[:B * H].view(B, H), buf[B * H:2 * B * H].view(B, H),
            buf[2 * B * H:].view(B, H, D))


def decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   kv_start: int, pos: IntOrTensor, window: int = 0,
                   block_kv: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the dense kernel's ``PARTIAL`` mode on CUDA tensors: the
    ``(m, l, acc)`` of a ``(B, Sl, K, D)`` slice whose first row is the
    global row ``kv_start``, per-slot global positions ``pos``.  Raises on
    any other device or input the kernel does not take."""
    global partial_launches
    _on_card("decode_partial", q)
    tile = kernel_tile("decode_partial", block_kv)
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    ps = _lengths(pos, B, q.device)
    _check("decode_partial", q, [("q", q), ("k", k), ("v", v)],
           [("pos", ps)])
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_partial: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    splits, rows = decode_split(B, K, S, tile)
    buf, m, l, acc = _partial_out(q)
    ws = _workspace(q, K, splits)
    err = build.library("decode_attention").decode_partial(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ps.data_ptr(),
        buf.data_ptr(), ws.data_ptr(), _counters(q.device, B * K).data_ptr(),
        B, S, H, K, D, int(kv_start), int(window), splits, rows,
        float(D ** -0.5), -1, torch.cuda.current_stream(q.device).cuda_stream)
    _launch_error("decode_partial", err)
    partial_launches += 1
    return m, l, acc


def paged_decode_partial(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tbl: torch.Tensor, *,
                         block_start: int, pos: IntOrTensor, window: int = 0,
                         block_kv: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the paged kernel's ``PARTIAL`` mode on CUDA tensors: the
    ``(m, l, acc)`` over the blocks of a ``(Nl, bl, K, D)`` sub-pool
    whose first block is the global block ``block_start``, through the
    global ``(B, nb)`` table.  Raises on any other device or input the
    kernel does not take."""
    global paged_partial_launches
    _on_card("paged_decode_partial", q)
    tile = kernel_tile("paged_decode_partial", block_kv)
    B, H, D = q.shape
    Nl, bl, K = k_pool.shape[:3]
    ps = _lengths(pos, B, q.device)
    _check("paged_decode_partial", q,
           [("q", q), ("k_pool", k_pool), ("v_pool", v_pool)],
           [("block_tbl", block_tbl), ("pos", ps)])
    if v_pool.shape != k_pool.shape or k_pool.shape[3] != D \
            or block_tbl.shape[0] != B:
        raise ValueError(f"paged_decode_partial: shapes q {tuple(q.shape)} "
                         f"pool {tuple(k_pool.shape)} "
                         f"table {tuple(block_tbl.shape)}")
    nb = block_tbl.shape[1]
    splits, rows = decode_split(B, K, nb * bl, tile)
    buf, m, l, acc = _partial_out(q)
    ws = _workspace(q, K, splits)
    err = build.library("decode_attention").paged_decode_partial(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tbl.data_ptr(), ps.data_ptr(), buf.data_ptr(), ws.data_ptr(),
        _counters(q.device, B * K).data_ptr(), B, H, K, D, bl, nb, Nl,
        int(block_start), int(window), splits, rows, float(D ** -0.5), -1,
        torch.cuda.current_stream(q.device).cuda_stream)
    _launch_error("paged_decode_partial", err)
    paged_partial_launches += 1
    return m, l, acc


# =====================================================================
# K9: decode over a rank's head_dim slice (csrc/decode_split.cu)
# =====================================================================

#: (GQA group, head_dim / m) pairs K9 is built for (``csrc/decode_split.cu``
#: ``REPRO_SPLIT_CASES``): what hymba-1.5b's head_dim-split plans reach at
#: m = 2 and 4 (its padded 26 / 13 heads at 32 columns, 28 / 7 at 16), its
#: unpadded group of 5 at both, and qwen3-8b's group of 4 at 64
SPLIT_INSTANCES = ((2, 32), (4, 16), (5, 32), (5, 16), (4, 64))
#: a pass-2 split covers a whole number of these compact columns (the
#: rows of one register stage, ``csrc`` ``kCtxLoads * kCtxRows``)
SPLIT_TILE = 128
#: the stages a pass-2 split aims at (a cluster takes more where it must)
SPLIT_TILES = 2
#: threads of pass-2 CTAs one SM holds at once, for the split rule's wave
#: (a quarter of its 2,048: the kernel's 96-128 registers a thread allow
#: 512-640)
SPLIT_SM_THREADS = 512
#: pass 2's splits of one (slot, kv head) form one thread-block cluster
#: of at most this many CTAs (the portable cluster size)
SPLIT_CLUSTER = 8

#: launches of K9's passes in this process (reset by the caller)
split_scores_launches = 0
split_context_launches = 0


def takes_split(G: int, DS: int) -> bool:
    """K9's admission rule: ``G`` query heads per kv head over ``DS``
    columns of each head is one of :data:`SPLIT_INSTANCES`."""
    return (G, DS) in SPLIT_INSTANCES


def admit_split(name: str, H: int, K: int, DS: int) -> None:
    """Raise where K9 has no instance for ``H`` query heads over ``K``
    kv heads at ``DS`` columns a head: the rule its launches and fake
    calls apply."""
    if H % K or not takes_split(H // K, DS):
        raise ValueError(f"{name}: K9 takes (GQA group, columns) in "
                         f"{SPLIT_INSTANCES}, got H={H} K={K} DS={DS}")


def split_cols(capacity: int, window: int) -> int:
    """``Wc``, the columns of K9's compact score buffer over a view of
    ``capacity`` rows: ``min(capacity, window)`` with a window, else
    ``capacity``.  It reads the shapes and the window alone."""
    return min(capacity, window) if window > 0 else capacity


def context_split(B: int, K: int, DS: int, cols: int) -> Tuple[int, int]:
    """``(splits, rows)`` of pass 2 over ``cols`` compact columns of
    ``B * K`` (slot, kv head) pairs, ``DS`` columns a row: split ``p``
    covers the columns ``[p * rows, (p + 1) * rows)``, ``rows`` a
    multiple of :data:`SPLIT_TILE`.  :data:`SPLIT_TILES` tiles a split,
    with no more splits than one wave of the grid holds (CTAs of ``4 *
    DS`` threads, :data:`SPLIT_SM_THREADS` of them an SM) and than one
    cluster takes: :data:`SPLIT_CLUSTER`.  It reads no ``cache_len``."""
    tiles = -(-cols // SPLIT_TILE)
    wave = SMS * SPLIT_SM_THREADS // (4 * DS) // max(1, B * K)
    splits = max(1, min(SPLIT_CLUSTER, -(-tiles // SPLIT_TILES), wave))
    rows = SPLIT_TILE * -(-tiles // splits)
    return -(-cols // rows), rows


def _compact(cache_len: IntOrTensor, B: int, C: int, window: int, device
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compact layout over each slot's view of ``C`` rows: ``(rows,
    live)``, both ``(B, Wc)``.  Column ``x`` of slot ``b`` is the row
    ``lo_b + x`` (clamped into the view), live for ``x < len_b - lo_b``,
    where ``len_b = min(cache_len_b, C)`` and ``lo_b = len_b - window``
    (0 without a window)."""
    cl = _lengths(cache_len, B, device).long().clamp(0, C)[:, None]
    lo = (cl - window).clamp_min(0) if window > 0 else torch.zeros_like(cl)
    x = torch.arange(split_cols(C, window), device=device)[None, :]
    return (lo + x).clamp(max=C - 1), x < cl - lo


def _view(t: torch.Tensor, block_tbl: Optional[torch.Tensor]
          ) -> torch.Tensor:
    """A dense ``(B, C, K, DS)`` view: ``t`` as it is, or a pool's
    blocks gathered through the table (``-1`` entries as zero rows)."""
    if block_tbl is None:
        return t
    tbl = block_tbl.long()
    live = (tbl >= 0)[..., None, None, None]
    g = torch.where(live, t[tbl.clamp_min(0)], 0)
    return g.reshape(tbl.shape[0], -1, *t.shape[2:])


def _compact_view(t: torch.Tensor, block_tbl: Optional[torch.Tensor],
                  cache_len: IntOrTensor, window: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of the compact layout, ``(B, Wc, K, DS)``, and their
    liveness ``(B, Wc)``."""
    kv = _view(t, block_tbl)
    B = kv.shape[0]
    rows, live = _compact(cache_len, B, kv.shape[1], window, t.device)
    return kv[torch.arange(B, device=t.device)[:, None], rows], live


def decode_split_scores_plain(q: torch.Tensor, k: torch.Tensor,
                              block_tbl: Optional[torch.Tensor] = None, *,
                              cache_len: IntOrTensor, window: int = 0,
                              scale: float) -> torch.Tensor:
    """Pass 1 in plain PyTorch: q ``(B, H, DS)`` (the rank's columns of
    every query head) against a dense ``(B, S, K, DS)`` slice, or a
    ``(N, bl, K, DS)`` pool through ``block_tbl``: the fp32 partial
    scores scaled by ``scale`` (the whole head_dim's ``D^-0.5``) in the
    compact layout ``(B, H, Wc)`` (:func:`split_cols`): column ``x`` of
    slot ``b`` is its live row ``lo_b + x``, 0 past its live count."""
    kv, live = _compact_view(k, block_tbl, cache_len, window)
    B, H, DS = q.shape
    K = kv.shape[2]
    s = torch.einsum("bkgd,bckd->bkgc",
                     q.reshape(B, K, H // K, DS).float() * scale, kv.float())
    return torch.where(live[:, None, None, :], s, 0.0).reshape(B, H, -1)


def decode_split_context_plain(s: torch.Tensor, v: torch.Tensor,
                               block_tbl: Optional[torch.Tensor] = None, *,
                               cache_len: IntOrTensor, window: int = 0
                               ) -> torch.Tensor:
    """Pass 2 in plain PyTorch: the summed compact scores ``(B, H, Wc)``,
    masked to each slot's live count, through an fp32 softmax against
    the rank's V columns of the same rows (dense ``(B, S, K, DS)``, or a
    pool through the table): the context's ``(B, H, DS)`` columns in V's
    dtype; zeros for a slot with no live row."""
    vv, live = _compact_view(v, block_tbl, cache_len, window)
    B, H, Wc = s.shape
    K, DS = vv.shape[2], vv.shape[3]
    live = live[:, None, None, :]
    sc = torch.where(live, s.reshape(B, K, H // K, Wc).float(),
                     float("-inf"))
    m = sc.amax(-1, keepdim=True)
    p = torch.where(live, torch.exp(sc - m), 0.0)
    o = torch.einsum("bkgc,bckd->bkgd", p, vv.float())
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, H, DS).to(v.dtype)


def decode_split_context_splits(s: torch.Tensor, v: torch.Tensor,
                                block_tbl: Optional[torch.Tensor] = None, *,
                                cache_len: IntOrTensor, window: int = 0,
                                rows: Optional[int] = None,
                                drop_split: int = -1) -> torch.Tensor:
    """Pass 2's split-and-merge arithmetic in plain fp32 PyTorch: split
    ``p`` (:func:`context_split`'s, or of ``rows`` columns each) takes
    the partial ``(m, l, acc)`` of its live compact columns, an empty
    split ``m = -inf, l = 0``, and the partials merge in split order,
    empty ones absent; ``drop_split`` leaves one out (a planted fault).
    The tests hold it against :func:`decode_split_context_plain`;
    nothing on the main path calls it."""
    vv, live = _compact_view(v, block_tbl, cache_len, window)
    B, H, Wc = s.shape
    K, DS = vv.shape[2], vv.shape[3]
    rows = rows or context_split(B, K, DS, Wc)[1]
    x = torch.arange(Wc, device=s.device)[None, :]
    sc = s.reshape(B, K, H // K, Wc).float()
    parts = []
    for i in range(-(-Wc // rows)):
        ok = (live & (x >= i * rows) & (x < (i + 1) * rows))[:, None, None]
        si = torch.where(ok, sc, float("-inf"))
        m = si.amax(-1)                                        # (B, K, G)
        p = torch.where(ok, torch.exp(si - m[..., None]), 0.0)
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgc,bckd->bkgd", p, vv.float())))
    kept = [t for i, t in enumerate(parts) if i != drop_split]
    m_all = torch.stack([m for m, _, _ in kept]).amax(0)
    acc = torch.zeros_like(kept[0][2])
    lsum = torch.zeros_like(kept[0][1])
    for m, l, a in kept:
        f = torch.where(m == float("-inf"), 0.0, torch.exp(m - m_all))
        acc = acc + f[..., None] * a
        lsum = lsum + f * l
    o = torch.where(lsum[..., None] > 0,
                    acc / lsum.clamp_min(1e-30)[..., None], 0.0)
    return o.reshape(B, H, DS).to(v.dtype)


def _split_check(name: str, cache: torch.Tensor,
                 block_tbl: Optional[torch.Tensor], cl: torch.Tensor,
                 heads: int) -> Tuple[int, int, int]:
    """``(seq, nb, K)`` of a K9 launch over ``cache`` (a dense slice or
    a pool); raises on any other device or input it does not take."""
    _on_card(name, cache)
    if cache.dtype != torch.bfloat16 or not cache.is_contiguous() \
            or cache.data_ptr() % 16:
        raise TypeError(f"{name}: the cache slice must be contiguous, "
                        "16-byte aligned bfloat16")
    ints = [("cache_len", cl)] + ([("block_tbl", block_tbl)]
                                  if block_tbl is not None else [])
    for tname, t in ints:
        if t.device != cache.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous int32 on "
                             f"{cache.device}")
    K, DS = cache.shape[2], cache.shape[3]
    admit_split(name, heads, K, DS)
    if block_tbl is None:
        return cache.shape[1], 0, K
    return cache.shape[1], block_tbl.shape[1], K


def decode_split_scores(q: torch.Tensor, k: torch.Tensor,
                        block_tbl: Optional[torch.Tensor] = None, *,
                        cache_len: IntOrTensor, window: int = 0,
                        scale: float, drop_chunk: int = -1) -> torch.Tensor:
    """Launch K9's pass 1 on CUDA tensors (the contract of
    :func:`decode_split_scores_plain`; raises on any other device or
    input the kernel does not take).  ``drop_chunk`` plants a fault for
    the checks: that 16-byte column chunk is left out of every score."""
    global split_scores_launches
    B, H, DS = q.shape
    cl = _lengths(cache_len, B, q.device)
    seq, nb, K = _split_check("decode_split_scores", k, block_tbl, cl, H)
    if q.dtype != torch.bfloat16 or not q.is_contiguous() \
            or q.data_ptr() % 16 \
            or q.device != k.device or k.shape[3] != DS or (
            block_tbl is None and k.shape[0] != B) or (
            block_tbl is not None and block_tbl.shape[0] != B):
        raise ValueError(f"decode_split_scores: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    cols = split_cols(seq if block_tbl is None else nb * seq, int(window))
    s = torch.empty((B, H, cols), dtype=torch.float32, device=q.device)
    err = build.library("decode_split").decode_split_scores(
        q.data_ptr(), k.data_ptr(),
        block_tbl.data_ptr() if block_tbl is not None else None,
        cl.data_ptr(), s.data_ptr(), B, H, K, DS, seq, nb, cols,
        int(window), float(scale), int(drop_chunk),
        torch.cuda.current_stream(q.device).cuda_stream)
    _launch_error("decode_split_scores", err)
    split_scores_launches += 1
    return s


def decode_split_context(s: torch.Tensor, v: torch.Tensor,
                         block_tbl: Optional[torch.Tensor] = None, *,
                         cache_len: IntOrTensor, window: int = 0,
                         swap_entry: bool = False) -> torch.Tensor:
    """Launch K9's pass 2 on CUDA tensors (the contract of
    :func:`decode_split_context_plain`; raises on any other device or
    input the kernel does not take): one launch, the splits of a (slot,
    kv head) merged inside it (one thread-block cluster).  ``swap_entry`` plants a fault for the
    checks: each slot's table entries 0 and 1 are read in each other's
    place."""
    global split_context_launches
    B, H, cols = s.shape
    cl = _lengths(cache_len, B, s.device)
    seq, nb, K = _split_check("decode_split_context", v, block_tbl, cl, H)
    DS = v.shape[3]
    cap = seq if block_tbl is None else nb * seq
    if s.dtype != torch.float32 or not s.is_contiguous() \
            or s.device != v.device or cols != split_cols(cap, int(window)):
        raise ValueError(f"decode_split_context: scores {tuple(s.shape)} "
                         f"{s.dtype} against v {tuple(v.shape)}, window "
                         f"{window}: K9 takes the compact (B, H, "
                         f"{split_cols(cap, int(window))}) fp32 buffer")
    splits, rows = context_split(B, K, DS, cols)
    out = torch.empty((B, H, DS), dtype=torch.bfloat16, device=s.device)
    err = build.library("decode_split").decode_split_context(
        s.data_ptr(), v.data_ptr(),
        block_tbl.data_ptr() if block_tbl is not None else None,
        cl.data_ptr(), out.data_ptr(), B, H, K, DS, seq, nb, cols,
        int(window), splits, rows, int(bool(swap_entry)),
        torch.cuda.current_stream(s.device).cuda_stream)
    _launch_error("decode_split_context", err)
    split_context_launches += 1
    return out
