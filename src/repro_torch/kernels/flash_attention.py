"""Flash attention, forward and backward: the Hopper kernels and their
plain versions, and the autograd function that joins them.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``, and the packed-causal grid
``_flash_causal_packed``).  The CUDA source is
``csrc/flash_attention.cu``; its header says what bounds it on the card
and how the design answers that.

Contract (a superset of the Pallas one): q ``(B, Sq, H, D)``, k/v
``(B, Skv, K, D)`` with ``Sq <= Skv``, GQA with ``H % K == 0``, causal
and sliding-window masks, any lengths (the ragged edge is masked; Pallas
asserted ``S % block == 0``).  The queries are the key stream's last
``Sq`` positions: query row ``i`` sits at absolute position ``Skv - Sq +
i`` (bottom-right-aligned causal), so ``Sq == Skv`` is a whole prompt
and ``Sq < Skv`` a prompt's tail prefilled over a resident prefix (the
JAX package's ``attention_tail``).  Output has q's dtype.
:func:`flash_attention` launches the kernel on CUDA tensors and raises
on any other device;
:mod:`repro_torch.kernels.ops` sends a CPU tensor to
:func:`flash_attention_plain` (one masked softmax in fp32, no tiles).

Tiles: the kernel's CTA holds ``rows`` = 64 or 128 query rows, 64 to
each consumer warpgroup: ``block_q = rows // G`` whole positions times
the ``G = H/K`` heads sharing a kv head, and streams ``block_kv`` K/V
rows a tile through a TMA ring of :data:`STAGES` stages.  A group that
divides no tile leaves pad rows (G = 7: 18 positions = 126 of 128 rows)
that the kernel never writes (G = 5: 25 positions = 125 of 128 rows).
It is built for ``(rows, block_kv)`` in :data:`KERNEL_TILES`, the head
dims in :data:`HEAD_DIMS` and the groups in :data:`GROUPS`;
:func:`kernel_tiles` raises on any other plan tile or group.  A plan without a ``flash_attention``
BlockPlan (decode shapes have none) gets :data:`DEFAULT_ROWS` x
:data:`DEFAULT_BLOCK_KV`, 164,920 B of shared memory at head_dim 128
(83,000 B at 64; at 80 as at 128: the tiles are padded to 128 columns),
one CTA to an SM.
TMA reads q, k and v in place, so each must start on a 16-byte boundary.

Backward: ``csrc/flash_attention_bwd.cu`` (FlashAttention-2's
arithmetic on ``wgmma`` fed by TMA, three launches: Delta and the dK/dV
row table, then dK/dV with keys as the 64-row side, causal key tiles
paired ``c`` with ``n - 1 - c`` a CTA, then dQ per 128 query rows; its
header says what bounds it).  The JAX package has no backward kernel (it
differentiates its XLA mirror), and its plan has no backward
``BlockPlan``; the backward's tiles are fixed in the source and
documented here: :data:`BWD_TILE_KV` keys a dK/dV job and a step of the
dQ loop, :data:`BWD_ROWS_KV` Q-tile rows a step of the dK/dV loop
(``64 // G`` positions times the G heads), :data:`BWD_ROWS_Q` query
rows a dQ CTA.  :class:`FlashAttention` is the
gradient route: its forward keeps q, k, v, the output and the
log-sum-exp the kernel writes, and its backward runs
:func:`flash_attention_bwd` on CUDA tensors or
:func:`flash_attention_bwd_plain` on the CPU.

Masks by positions: every function here takes an optional int32
``positions`` ``(B, Skv)``, one position per key row, query row ``i``
at ``positions[:, Skv - Sq + i]``; the masks then compare positions
(causal ``kpos <= qpos``, the window ``qpos - kpos < window``), as the
JAX package masks by M-RoPE's temporal stream
(``src/repro/models/attention.py:41-55``), where every patch of an
image shares one id.  Positions need not rise with the row.  The
kernels' positions variant (``POS``, built at head_dim
:data:`POS_HEAD_DIM`) skips and masks tiles by each tile's range of
positions; without ``positions`` they run the index path unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

#: (query rows, kv rows) the CUDA kernel is instantiated for: one or two
#: 64-row consumer warpgroups, 64- or 128-row K/V tiles
KERNEL_TILES = ((64, 64), (64, 128), (128, 64), (128, 128))
DEFAULT_ROWS = 128
DEFAULT_BLOCK_KV = 128
#: head dims the kernel is instantiated at: one 128-byte swizzle row of
#: bf16 (hymba-1.5b's 64) or two (128); hubert-xlarge's 80 is padded to
#: two in shared memory (TMA zero-fills columns 80..127)
HEAD_DIMS = (64, 80, 128)
#: GQA groups (query heads per kv head) the kernel is checked at: the
#: powers of two, hymba-1.5b's 5, deepseek-coder-33b's 7, and 3, a rank
#: of llama4-maverick's 16-wide model axis (3 of the padded group of 6
#: over one kv head, :func:`repro_torch.models.tp.flash_group`: 42
#: positions in 128 rows, 2 pad)
GROUPS = (1, 2, 3, 4, 5, 7, 8, 16)
#: K/V stages of the TMA ring in shared memory
STAGES = 2
#: the head dim the kernels' positions variant is built at (qwen2-vl-72b,
#: the one arch whose mask positions are not the row index)
POS_HEAD_DIM = 128

#: backward tiles (``csrc/flash_attention_bwd.cu``): keys a dK/dV job
#: and a step of the dQ loop, (position, head) rows a step of the dK/dV
#: loop, query rows a dQ CTA
BWD_TILE_KV = 64
BWD_ROWS_KV = 64
BWD_ROWS_Q = 128

#: launches of the CUDA kernels in this process (reset by the caller):
#: forward calls, how many of them ran a query block at an offset (``Sq <
#: Skv``), backward calls (one call is the backward's three launches),
#: and the forward and backward calls that masked by positions
launches = 0
tail_launches = 0
bwd_launches = 0
pos_launches = 0
pos_bwd_launches = 0


def padded_dim(head_dim: int) -> int:
    """The width the kernels' tiles and products have: ``head_dim``
    rounded up to whole 64-column (128-byte) swizzle atoms, 128 at 80
    (``csrc`` ``padded_dim``)."""
    return -(-head_dim // 64) * 64


def smem_bytes(rows: int, block_kv: int, head_dim: int = 128) -> int:
    """Dynamic shared memory one CTA asks for (``csrc`` ``Smem::kBytes``):
    the Q tile, :data:`STAGES` K and V tiles at the padded width
    (:func:`padded_dim`), the ring's mbarriers and 1 KB to align the
    tiles to the 128-byte swizzle's 1024-byte atom.  S, P and the O
    accumulator live in registers."""
    bars = (1 + 3 * STAGES) * 8
    d = padded_dim(head_dim)
    return rows * d * 2 + STAGES * 2 * block_kv * d * 2 + bars + 1024


def bwd_table_floats(B: int, Sq: int, H: int, K: int) -> int:
    """fp32 elements of the backward's dK/dV row table: for each
    ``(b, kv head, Q tile)`` of :data:`BWD_ROWS_KV` rows, their
    log-sum-exp and Delta (``csrc/flash_attention_bwd.cu`` pass 1)."""
    per_tile = BWD_ROWS_KV // (H // K)
    return B * K * -(-Sq // per_tile) * 2 * BWD_ROWS_KV


def pos_ranges_ints(B: int, Sq: int, Skv: int, tiles) -> int:
    """int32 elements of the positions variant's range workspace: a
    ``[min, max]`` pair per ``(b, tile)`` of each ``(start, length,
    rows)`` table in ``tiles`` (``csrc/positions.cuh``)."""
    return 2 * B * sum(-(-n // t) for n, t in tiles)


def causal_pairs(Sq: int, Skv: int, window: int = 0) -> int:
    """Live (query, key) pairs of one sequence whose ``Sq`` queries are
    the last of ``Skv`` keys, causal, under a window counted back from
    each query (0: none)."""
    M = Skv - Sq
    if not window:
        return Sq * M + Sq * (Sq + 1) // 2
    lo, hi = M + 1, min(Skv, window)     # queries that see every key
    whole = (lo + hi) * (hi - lo + 1) // 2 if hi >= lo else 0
    return whole + window * max(0, Skv - max(M, window))


def work(B: int, Sq: int, Skv: int, H: int, K: int, D: int, *,
         causal: bool = True, window: int = 0,
         pairs: Optional[int] = None, positions: bool = False,
         lse: bool = False, itemsize: int = 2) -> Tuple[float, float]:
    """``(flops, bytes)`` of one forward call: 4 D a live (query, key)
    pair a query head (``pairs``, over the batch, where a mask by
    positions decides them; else :func:`causal_pairs`, or ``Sq * Skv``
    non-causal), and q, k, v read once and the output written once
    (with ``positions`` their int32 row; with ``lse`` the fp32
    log-sum-exp written for the backward)."""
    if pairs is None:
        pairs = B * (causal_pairs(Sq, Skv, window) if causal else Sq * Skv)
    nbytes = itemsize * (2 * B * Sq * H * D + 2 * B * Skv * K * D)
    nbytes += 4 * B * Skv * positions + 4 * B * H * Sq * lse
    return 4.0 * D * H * pairs, float(nbytes)


def bwd_work(B: int, Sq: int, Skv: int, H: int, K: int, D: int, *,
             causal: bool = True, window: int = 0,
             pairs: Optional[int] = None, positions: bool = False,
             itemsize: int = 2) -> Tuple[float, float]:
    """``(flops, bytes)`` of one backward call: 2.5 times the forward's
    products (S and P again, dV, dP, dS, dQ, dK), and q, o, dO, k, v,
    the log-sum-exp (and positions) read once, dq, dk, dv written
    once."""
    flops, _ = work(B, Sq, Skv, H, K, D, causal=causal, window=window,
                    pairs=pairs)
    nbytes = itemsize * (3 * B * Sq * H * D + 2 * B * Skv * K * D) \
        + 4 * B * H * Sq + 4 * B * Skv * positions \
        + itemsize * (B * Sq * H * D + 2 * B * Skv * K * D)
    return 2.5 * flops, float(nbytes)


def _call_work(q, k, causal: bool, window: int, positions, bwd: bool,
               lse: bool = False) -> Tuple[float, float]:
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    kw = dict(causal=causal, window=window, positions=positions is not None,
              itemsize=q.element_size())
    if bwd:
        return bwd_work(B, Sq, Skv, H, K, D, **kw)
    return work(B, Sq, Skv, H, K, D, lse=lse, **kw)


def flash_attention_fake(q, k, v, *, causal: bool = True, window: int = 0,
                         return_lse: bool = False,
                         positions: Optional[torch.Tensor] = None,
                         tiles: Optional[Tuple[int, int]] = None):
    """The forward's fake path (:mod:`repro_torch.kernels.fake`): outputs
    of the kernel's shapes and dtypes, the call's :func:`work` recorded
    under its ``ops.launch_counts()`` key; nothing built or launched.
    A mask by positions is counted over every pair the index mask
    keeps (a fake tensor's positions are not known).  Raises where the
    launch at the plan's ``tiles`` would (:func:`admit`)."""
    from repro_torch.kernels import fake
    B, Sq, H, _ = q.shape
    _admit_call(q, k, tiles, positions)
    fake.record("flash_attention_positions" if positions is not None
                else "flash_attention",
                _call_work(q, k, causal, window, positions, False,
                           return_lse))
    o = torch.empty_like(q)
    if not return_lse:
        return o
    return o, q.new_empty((B, H, Sq), dtype=torch.float32)


def flash_attention_bwd_fake(q, k, v, *, causal: bool = True,
                             window: int = 0,
                             positions: Optional[torch.Tensor] = None):
    """The backward's fake path: ``dq, dk, dv`` of q, k and v's shapes,
    :func:`bwd_work` recorded; raises where the launch would
    (:func:`admit`, ``bwd=True``)."""
    from repro_torch.kernels import fake
    _admit_call(q, k, None, positions, bwd=True)
    fake.record("flash_attention_bwd_positions" if positions is not None
                else "flash_attention_bwd",
                _call_work(q, k, causal, window, positions, True))
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def admit(H: int, K: int, D: int,
          tiles: Optional[Tuple[int, int]] = None, *,
          positions: bool = False, bwd: bool = False) -> None:
    """Raise where the kernels have no instance for ``H`` query heads
    over ``K`` kv heads at head_dim ``D``: a head_dim outside
    :data:`HEAD_DIMS`, a GQA group outside :data:`GROUPS` or without
    the plan's ``tiles``
    (:func:`kernel_tiles`), the positions variant off
    :data:`POS_HEAD_DIM`, or (``bwd``) a group wider than a dK/dV step.
    The rule every launch and every fake call applies."""
    name = "flash_attention_bwd" if bwd else "flash_attention"
    if D not in HEAD_DIMS or H % K:
        raise ValueError(f"{name}: kernel takes head_dim in {HEAD_DIMS} "
                         f"and H % K == 0, got D={D} H={H} K={K}")
    kernel_tiles(H // K, *(tiles or (None, None)))
    if positions and D != POS_HEAD_DIM:
        raise ValueError(
            f"{name}: the positions variant is built at head_dim "
            f"{POS_HEAD_DIM} (qwen2-vl-72b's M-RoPE), got {D}")
    if bwd and H // K > BWD_ROWS_KV:
        raise ValueError(f"{name}: GQA group {H // K} > {BWD_ROWS_KV} rows "
                         "of a dK/dV step")


def _admit_call(q, k, tiles=None, positions=None, bwd=False) -> None:
    admit(q.shape[2], k.shape[2], q.shape[3], tiles,
          positions=positions is not None, bwd=bwd)


def kernel_tiles(G: int, block_q: Optional[int] = None,
                 block_kv: Optional[int] = None) -> Tuple[int, int]:
    """``(rows, block_kv)`` for a GQA group of ``G`` heads: the CTA's
    rows whose ``rows // G`` whole positions are the plan's ``block_q``,
    or the documented default.  Raises on a group or a tile the kernel
    cannot run — never substitutes another."""
    if G not in GROUPS:
        raise ValueError(
            f"flash_attention: GQA group G = {G} is not one the kernel is "
            f"checked at {GROUPS}")
    if block_q is None and block_kv is None:
        return DEFAULT_ROWS, DEFAULT_BLOCK_KV
    if block_q is None or block_kv is None:
        raise ValueError("flash_attention: give both block_q and block_kv")
    rows = next((r for r, bkv in KERNEL_TILES
                 if r // G == block_q and bkv == block_kv), None)
    if rows is None:
        raise ValueError(
            f"flash_attention: tile block_q={block_q} positions x G={G}, "
            f"block_kv={block_kv} is not one the kernel is built for "
            f"{KERNEL_TILES} (block_q = rows // G)")
    return rows, block_kv


def _mask(Sq: int, Skv: int, causal: bool, window: int, device,
          positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Live (query, key) pairs: queries at the key stream's last ``Sq``
    rows, causal bottom-right aligned, the window counted back from each
    query; ``(Sq, Skv)`` by row index, or ``(B, 1, 1, Sq, Skv)`` by
    ``positions`` ``(B, Skv)`` (query row ``i`` at ``positions[:, Skv -
    Sq + i]``), broadcast against ``(B, K, G, Sq, Skv)`` scores."""
    if positions is None:
        qpos = torch.arange(Skv - Sq, Skv, device=device)[:, None]
        kpos = torch.arange(Skv, device=device)[None, :]
    else:
        pos = positions.to(device=device, dtype=torch.int64)
        qpos = pos[:, Skv - Sq:, None]
        kpos = pos[:, None, :]
    ok = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                    dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= (qpos - kpos) < window
    return ok if positions is None else ok[:, None, None]


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Scaled fp32 scores ``(B, K, G, Sq, Skv)``."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    return torch.einsum("bqkgd,bskd->bkgqs",
                        q.reshape(B, Sq, K, H // K, D).float(),
                        k.float()) * (D ** -0.5)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0, return_lse: bool = False,
                          positions: Optional[torch.Tensor] = None):
    """The kernel's function in plain PyTorch: one masked softmax over
    all key positions in fp32, the same superset contract (any lengths,
    queries the last ``Sq`` of ``Skv`` rows, masked by row index or by
    ``positions`` ``(B, Skv)``).  Runs on any device.
    ``return_lse`` also returns each row's log-sum-exp of the scaled
    scores, fp32 ``(B, H, Sq)``, as the kernel writes it for the
    backward."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if Sq > Skv:
        raise ValueError(f"flash_attention: {Sq} queries over {Skv} keys; "
                         "the queries are the key stream's last positions")
    _check_positions(positions, B, Skv)
    s = torch.where(_mask(Sq, Skv, causal, window, q.device, positions),
                    _scores(q, k), float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o.reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              positions: Optional[torch.Tensor] = None):
    """The backward kernel's function in plain PyTorch, in fp32, step by
    step: P from the scores and the forward's log-sum-exp, ``Delta =
    rowsum(dO o O)``, ``dS = P o (dP - Delta)``, ``dQ = scale dS K``,
    ``dK = scale dS^T Q`` and ``dV = P^T dO`` summed over the G query
    heads of each kv head, masked by row index or by ``positions``.
    Returns ``(dq, dk, dv)`` in the inputs' dtype.  Runs on any device."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    _check_positions(positions, B, Skv)
    ok = _mask(Sq, Skv, causal, window, q.device, positions)
    lse5 = lse.float().reshape(B, K, G, Sq, 1)
    p = torch.where(ok, torch.exp(_scores(q, k) - lse5), 0.0)
    do5 = do.reshape(B, Sq, K, G, D).float()
    o5 = o.reshape(B, Sq, K, G, D).float()
    delta = (do5 * o5).sum(-1).permute(0, 2, 3, 1)[..., None]  # (B,K,G,Sq,1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do5, v.float())
    ds = p * (dp - delta)
    scale = D ** -0.5
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.reshape(B, Sq, K, G, D).float()) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do5)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_positions(positions: Optional[torch.Tensor], B: int,
                     Skv: int) -> None:
    if positions is not None and tuple(positions.shape) != (B, Skv):
        raise ValueError(f"flash_attention: positions "
                         f"{tuple(positions.shape)}, want (B, Skv) = "
                         f"{(B, Skv)}: one position per key row")


def _kernel_positions(positions: Optional[torch.Tensor], q: torch.Tensor,
                      Skv: int) -> Optional[torch.Tensor]:
    """``positions`` as the kernels read them: int32, contiguous, on q's
    device; raises at a head dim the positions variant is not built at."""
    if positions is None:
        return None
    B, _, _, D = q.shape
    _check_positions(positions, B, Skv)
    if D != POS_HEAD_DIM:
        raise ValueError(
            f"flash_attention: the positions variant is built at head_dim "
            f"{POS_HEAD_DIM} (qwen2-vl-72b's M-RoPE), got {D}")
    return positions.to(device=q.device, dtype=torch.int32).contiguous()


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            "kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not contiguous "
                             "and 16-byte aligned (TMA reads it in place)")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[1] < Sq or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)} (Sq <= Skv)")
    _admit_call(q, k)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: Optional[int] = None,
                    block_kv: Optional[int] = None,
                    ignore_offset: bool = False,
                    pad_fault: bool = False, return_lse: bool = False,
                    positions: Optional[torch.Tensor] = None,
                    ignore_positions: bool = False):
    """Launch the GQA flash kernel on CUDA tensors (raises on any other
    device or on inputs the kernel does not take).  ``return_lse`` also
    returns the log-sum-exp the kernel writes for the backward, fp32
    ``(B, H, Sq)`` (the serve path asks for none and the kernel writes
    none).  ``positions`` ``(B, Skv)`` masks by positions (the kernel's
    positions variant).  ``ignore_offset``, ``pad_fault`` and
    ``ignore_positions`` plant faults for the checks (tests and
    ``chip_smoke.py`` only): a tail's queries taken as positions
    ``0..Sq-1``; a tile's pad rows written over the next CTA's first
    position, in place of that CTA's own rows there (so the fault shows
    whichever CTA writes last); the positions dropped, so the kernel
    masks by row index."""
    global launches, tail_launches, pos_launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: the kernel runs on CUDA tensors, "
                         f"got {q.device} (kernels.ops routes CPU tensors to "
                         "the plain version)")
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    rows, bkv = kernel_tiles(H // K, block_q, block_kv)
    pos = None if ignore_positions else _kernel_positions(positions, q, Skv)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    ranges = None
    if pos is not None:
        ranges = torch.empty(
            pos_ranges_ints(B, Sq, Skv, ((Sq, rows // (H // K)),
                                         (Skv, bkv))),
            dtype=torch.int32, device=q.device)
    err = build.library("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        pos.data_ptr() if pos is not None else None,
        ranges.data_ptr() if pos is not None else None, B, Sq, Skv,
        0 if ignore_offset else Skv - Sq, H, K, D, int(causal),
        int(window), rows, bkv, float(D ** -0.5), int(pad_fault),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd: launch failed with "
                           f"{build.describe_error(err)}")
    launches += 1
    tail_launches += Sq < Skv
    pos_launches += pos is not None
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, drop_tile: bool = False,
                        group_fault: bool = False,
                        positions: Optional[torch.Tensor] = None,
                        ignore_positions: bool = False):
    """Launch the backward kernel on CUDA tensors: ``(dq, dk, dv)`` of
    the forward ``o = flash_attention(q, k, v)`` with its log-sum-exp
    ``lse`` and the output gradient ``do`` (raises on any other device
    or on inputs the kernel does not take), masked by ``positions``
    ``(B, Skv)`` when given.  ``drop_tile``, ``group_fault`` and
    ``ignore_positions`` plant faults for the checks (tests and
    ``chip_smoke.py`` only): each dK/dV job's first Q tile skipped; only
    a group's first query head summed into dK/dV; the positions dropped
    (the mask by row index)."""
    global bwd_launches, pos_bwd_launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: the kernel runs on CUDA "
                         f"tensors, got {q.device} (kernels.ops routes CPU "
                         "tensors to the plain version)")
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    for name, t, dtype, shape in (("o", o, torch.bfloat16, q.shape),
                                  ("do", do, torch.bfloat16, q.shape),
                                  ("lse", lse, torch.float32, (B, H, Sq))):
        if (t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"flash_attention_bwd: {name} must be a contiguous, 16-byte "
                f"aligned {dtype} {tuple(shape)} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    _admit_call(q, k, bwd=True)
    pos = None if ignore_positions else _kernel_positions(positions, q, Skv)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    table = torch.empty(bwd_table_floats(B, Sq, H, K), dtype=torch.float32,
                        device=q.device)
    ranges = None
    if pos is not None:
        G = H // K
        ranges = torch.empty(
            pos_ranges_ints(B, Sq, Skv, ((Sq, BWD_ROWS_KV // G),
                                         (Sq, BWD_ROWS_Q // G),
                                         (Skv, BWD_TILE_KV))),
            dtype=torch.int32, device=q.device)
    err = build.library("flash_attention_bwd").flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), table.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        pos.data_ptr() if pos is not None else None,
        ranges.data_ptr() if pos is not None else None, B, Sq, Skv,
        Skv - Sq, H, K, D,
        int(causal), int(window), float(D ** -0.5), int(drop_tile),
        int(group_fault), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd: launch failed with "
                           f"{build.describe_error(err)}")
    bwd_launches += 1
    pos_bwd_launches += pos is not None
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the kernels on CUDA tensors
    (forward and backward), the plain versions on the CPU, never one
    for the other.  The forward keeps q, k, v, the output, the
    log-sum-exp and the mask's ``positions`` (or ``None``) for the
    backward (O(S) beside the inputs: no score matrix is kept)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                tiles: Optional[Tuple[int, int]],
                positions: Optional[torch.Tensor] = None):
        from repro_torch.kernels import fake
        if fake.is_fake(q):
            o, lse = flash_attention_fake(q, k, v, causal=causal,
                                          window=window, return_lse=True,
                                          positions=positions,
                                          tiles=tiles)
        elif q.device.type == "cuda":
            bq, bkv = tiles if tiles is not None else (None, None)
            o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                     block_q=bq, block_kv=bkv,
                                     return_lse=True, positions=positions)
        else:
            o, lse = flash_attention_plain(q, k, v, causal=causal,
                                           window=window, return_lse=True,
                                           positions=positions)
        ctx.save_for_backward(q, k, v, o, lse, positions)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels import fake
        q, k, v, o, lse, positions = ctx.saved_tensors
        if fake.is_fake(q):
            return (*flash_attention_bwd_fake(
                q, k, v, causal=ctx.causal, window=ctx.window,
                positions=positions), None, None, None, None)
        bwd = (flash_attention_bwd if q.device.type == "cuda"
               else flash_attention_bwd_plain)
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(),
                         causal=ctx.causal, window=ctx.window,
                         positions=positions)
        return dq, dk, dv, None, None, None, None
