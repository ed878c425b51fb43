"""Sharded flash-decode over a KV cache split across the model axis.

The port of ``repro/dist/flash_decode.py``.  Where the data-organization
pass spills the cache's seq dim (or, paged, the pool dim) onto the model
axis, because the kv heads do not split that many ways, a decode step
needs two things:

1. the one-token append: only the rank that owns the row (the block)
   writes it, in its own piece;
2. the attention reduction: each rank computes the partial online
   softmax ``(m, l, acc)`` over its rows, and the ranks combine the
   three terms over the model axis (one MAX and two SUMs of per-query
   tensors, or one packed all-gather and a local fold), never gathering
   the cache.

Each function runs on every rank of the mesh with what the reference's
``shard_map`` would hand that rank: q, the new rows and ``pos`` are the
rank's batch rows (the batch splits over the data axes where they divide
it), the cache (pool) is the rank's piece.  ``seq_len`` / ``n_blocks``
and ``batch`` name the whole sizes, from which the dispatch predicates
decide; without them the tensors are taken as whole, and a predicate
that says they should have been split raises.  Caches are updated in
place, as everywhere in the port.

The partial runs through :mod:`repro_torch.kernels.ops`: the decode
kernels' ``PARTIAL`` mode (K8) on a CUDA tensor, the plain twin of the
reference's ``_partial_attend`` on a CPU one.  Collectives run on the
mesh's model group through ``torch.distributed``; which backend carries
them is the process group's business.  Semantics match
``kernels/ref.py``'s ``decode_attention_ref`` (paged:
``paged_decode_attention_ref``) with ``cache_len = pos + 1``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import mesh_sizes
from repro_torch.kernels import ops

_NINF = float("-inf")


def uses_seq_sharding(mesh, seq_len: int, model_axis: str = "model") -> bool:
    """Whether :func:`flash_decode` runs the seq-sharded path (vs the
    single-shard one): the one predicate ``ServeEngine.decode_path``
    shares."""
    msize = mesh_sizes(mesh).get(model_axis, 1)
    return msize > 1 and seq_len % msize == 0


def combine_topology(mesh, *, model_axis: str = "model",
                     override=None) -> str:
    """The model-axis combine a decode step runs: ``override`` (a plan-
    or caller-pinned ``flat`` / ``ring`` / ``bidir``) or the cost
    model's choice; ``flat`` on a model axis of one."""
    from repro_torch.core.costmodel import (COMBINE_TOPOLOGIES,
                                            choose_combine_topology)
    msize = mesh_sizes(mesh).get(model_axis, 1)
    if msize <= 1:
        return "flat"
    if override is not None:
        if override not in COMBINE_TOPOLOGIES:
            raise ValueError(f"unknown combine topology {override!r}; "
                             f"expected one of {COMBINE_TOPOLOGIES}")
        return override
    return choose_combine_topology(msize)


def _group_ranks(group) -> Tuple[int, Sequence[int]]:
    """``(index of this rank in group, the group's global ranks)``."""
    ranks = dist.get_process_group_ranks(group)
    return ranks.index(dist.get_rank()), ranks


def _ring_allgather(v: torch.Tensor, group, n: int,
                    bidir: bool = False) -> torch.Tensor:
    """All-gather ``v`` into an ``(n, ...)`` source-indexed buffer by
    neighbour sends (``dist.batch_isend_irecv``): ``out[j]`` holds the
    group's rank ``j``'s value on every rank.  ``bidir`` walks both
    ring directions, ``ceil((n-1)/2)`` hops forward and
    ``floor((n-1)/2)`` back; the arms fill disjoint slots."""
    idx, ranks = _group_ranks(group)
    out = v.new_zeros((n,) + tuple(v.shape))
    out[idx] = v

    def walk(hops: int, step: int) -> None:
        w = v
        for t in range(1, hops + 1):
            got = torch.empty_like(v)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, w.contiguous(),
                           ranks[(idx + step) % n], group),
                dist.P2POp(dist.irecv, got, ranks[(idx - step) % n],
                           group)])
            for r in reqs:
                r.wait()
            out[(idx - step * t) % n] = got
            w = got

    walk(n // 2 if bidir else n - 1, 1)
    if bidir:
        walk((n - 1) // 2, -1)
    return out


def _weights(m: torch.Tensor, m_glob: torch.Tensor) -> torch.Tensor:
    """``exp(m - m_glob)``, 0 for an empty partial (``m = -inf``, the
    kernel's), so a slot no shard has a row of combines to zeros."""
    return torch.where(m == _NINF, 0.0, torch.exp(m - m_glob))


def _combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
             group, msize: int, topology: str
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-rank online-softmax combine of the partial ``(m, l, acc)``
    over ``group``: ``flat`` is an all-reduce MAX and two SUMs;
    ``ring`` / ``bidir`` one packed all-gather of ``(m, l, acc)``, then
    a fold in source order, so the two are bitwise equal."""
    if topology == "flat":
        m_glob = m.clone()
        dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
        coef = _weights(m, m_glob)
        lw, aw = l * coef, acc * coef[..., None]
        dist.all_reduce(lw, group=group)
        dist.all_reduce(aw, group=group)
        return lw, aw
    packed = torch.cat([m[..., None], l[..., None], acc], dim=-1)
    g = _ring_allgather(packed, group, msize, bidir=(topology == "bidir"))
    ms, ls, accs = g[..., 0], g[..., 1], g[..., 2:]
    m_glob = ms[0]
    for i in range(1, msize):
        m_glob = torch.maximum(m_glob, ms[i])
    coef = _weights(ms, m_glob[None])
    lw, aw = ls * coef, accs * coef[..., None]
    l_glob, acc_glob = lw[0], aw[0]
    for i in range(1, msize):
        l_glob = l_glob + lw[i]
        acc_glob = acc_glob + aw[i]
    return l_glob, acc_glob


def _append(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor,
            in_range: torch.Tensor) -> torch.Tensor:
    """Write ``new[b, 0]`` at row ``idx[b]`` of ``cache[b]`` where
    ``in_range[b]`` (in place)."""
    b = torch.nonzero(in_range, as_tuple=True)[0]
    cache[b, idx.long()[b]] = new[b, 0].to(cache.dtype)
    return cache


def _partial_attend(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                    kv_start: int, pos: torch.Tensor, window: int,
                    block_kv: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(m, l, acc)`` of q ``(B, 1, H, D)`` over a dense slice whose
    first row is the global row ``kv_start`` (K8 on the card)."""
    return ops.decode_partial(q[:, 0], kc, vc, kv_start=kv_start, pos=pos,
                              window=window, block_kv=block_kv)


def _partial_attend_paged(q: torch.Tensor, kp: torch.Tensor,
                          vp: torch.Tensor, tbl: torch.Tensor,
                          pos: torch.Tensor, window: int, start: int = 0,
                          block_kv: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``(m, l, acc)`` over the blocks of a sub-pool whose first block
    is the global block ``start``, through the global table (K8 on the
    card)."""
    return ops.paged_decode_partial(q[:, 0], kp, vp, tbl, block_start=start,
                                    pos=pos, window=window,
                                    block_kv=block_kv)


def _finish(q: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
            ) -> torch.Tensor:
    ctx = acc / l.clamp_min(1e-30)[..., None]
    return ctx[:, None].to(q.dtype)


def _positions(pos, B: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return pos.expand(B).contiguous() if pos.dim() == 0 else pos


def _data(mesh, data_axes: Tuple[str, ...]):
    sizes = mesh_sizes(mesh)
    dnames = tuple(a for a in data_axes if a in sizes)
    return dnames, math.prod(sizes[a] for a in dnames) if dnames else 1


def _whole(what: str, got: int, want: int) -> None:
    if got != want:
        raise ValueError(
            f"flash_decode: {what} is {got} rows here but the dispatch "
            f"wants this rank's piece of {want}; pass the rank's piece and "
            "the whole size (seq_len / n_blocks / batch)")


def flash_decode(q: torch.Tensor,            # (B, 1, H, D)
                 k_new: torch.Tensor,        # (B, 1, K, D)
                 v_new: torch.Tensor,        # (B, 1, K, D)
                 k_cache: torch.Tensor,      # (B, S, K, D), this rank's piece
                 v_cache: torch.Tensor,
                 pos,                        # (B,) per-slot offsets
                 window: int = 0,
                 *, mesh,
                 data_axes: Tuple[str, ...] = ("data",),
                 model_axis: str = "model",
                 combine: Optional[str] = None,
                 seq_len: Optional[int] = None,
                 batch: Optional[int] = None,
                 block_kv: Optional[int] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against a (batch, seq)-sharded dense cache.

    Returns ``(ctx, k_cache, v_cache)``, ``ctx`` ``(B, 1, H, D)`` for the
    rank's batch rows.  The single-shard path runs where the model axis
    cannot split ``seq_len`` (size 1, or not a divisor); the batch
    splits over the data axes where they divide ``batch``.  ``combine``
    pins the combine (a plan's ``comm.combine_topology``)."""
    S = seq_len if seq_len is not None else k_cache.shape[1]
    Bg = batch if batch is not None else q.shape[0]
    pos = _positions(pos, q.shape[0], q.device)
    if not uses_seq_sharding(mesh, S, model_axis):
        _whole("the cache's seq dim", k_cache.shape[1], S)
        always = torch.ones_like(pos, dtype=torch.bool)
        _append(k_cache, k_new, pos, always)
        _append(v_cache, v_new, pos, always)
        m, l, acc = _partial_attend(q, k_cache, v_cache, 0, pos, window,
                                    block_kv)
        return _finish(q, l, acc), k_cache, v_cache

    sizes = mesh_sizes(mesh)
    msize = sizes[model_axis]
    _, dsize = _data(mesh, data_axes)
    want_b = Bg // dsize if dsize > 1 and Bg % dsize == 0 else Bg
    _whole("the batch", q.shape[0], want_b)
    Sl = S // msize
    _whole("the cache's seq dim", k_cache.shape[1], Sl)
    topology = combine_topology(mesh, model_axis=model_axis,
                                override=combine)
    group = mesh.get_group(model_axis)
    start = mesh.get_local_rank(model_axis) * Sl
    lp = pos - start                          # per-slot local offsets
    in_range = (lp >= 0) & (lp < Sl)          # only the owner writes
    _append(k_cache, k_new, lp.clamp(0, Sl - 1), in_range)
    _append(v_cache, v_new, lp.clamp(0, Sl - 1), in_range)
    m, l, acc = _partial_attend(q, k_cache, v_cache, start, pos, window,
                                block_kv)
    l, acc = _combine(m, l, acc, group, msize, topology)
    return _finish(q, l, acc), k_cache, v_cache


# =====================================================================
# paged residency: the pool dim takes the model axis
# =====================================================================

def uses_pool_sharding(mesh, n_blocks: int, model_axis: str = "model") -> bool:
    """Whether :func:`flash_decode_paged` can shard the pool on the
    model axis alone (the 1-D predicate)."""
    msize = mesh_sizes(mesh).get(model_axis, 1)
    return msize > 1 and n_blocks % msize == 0


def pool_sharding_kind(mesh, n_blocks: int, batch: int,
                       data_axes: Tuple[str, ...] = ("data",),
                       model_axis: str = "model") -> str:
    """Which path :func:`flash_decode_paged` runs, the predicate the
    engine's decode path and its sub-pool allocator share:

    ``"2d"``: the pool dim shards data-major over ``(data..., model)``
    and the batch splits across data (a data degree > 1 dividing the
    batch and, with the model degree, the pool); ``"1d"``: the pool
    shards on the model axis only and the batch stays whole;
    ``"none"``: the single-shard path."""
    sizes = mesh_sizes(mesh)
    msize = sizes.get(model_axis, 1)
    _, dsize = _data(sizes, data_axes)
    if dsize > 1 and batch % dsize == 0 \
            and n_blocks and n_blocks % (dsize * msize) == 0:
        return "2d"
    if msize > 1 and n_blocks % msize == 0:
        return "1d"
    return "none"


def flash_decode_paged(q: torch.Tensor,          # (B, 1, H, D)
                       k_new: torch.Tensor,      # (B, 1, K, D)
                       v_new: torch.Tensor,
                       k_pool: torch.Tensor,     # (N, bl, K, D), the piece
                       v_pool: torch.Tensor,
                       block_tbl: torch.Tensor,  # (B, nb) global ids, -1
                       pos,                      # (B,)
                       window: int = 0,
                       *, mesh,
                       data_axes: Tuple[str, ...] = ("data",),
                       model_axis: str = "model",
                       combine: Optional[str] = None,
                       n_blocks: Optional[int] = None,
                       batch: Optional[int] = None,
                       block_kv: Optional[int] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against a block pool sharded on its pool dim.

    Returns ``(ctx, k_pool, v_pool)``.  Dispatch is
    :func:`pool_sharding_kind` of ``n_blocks`` and ``batch``:

    * ``"2d"``: the rank holds the data-major ``(data..., model)`` piece
      of the pool and its data shard's batch rows; every slot's blocks
      lie in its data shard's sub-pool (the engine's allocator sees to
      it), the append lands on the one rank owning the block, and the
      combine runs over the model axis alone;
    * ``"1d"``: the rank holds its model piece of the pool, which
      replicates over the data axes, and the whole batch;
    * ``"none"``: the single-shard path over the whole pool.

    ``combine`` changes the combine's wire pattern, never its value."""
    from repro_torch.models.lm import append_kv_paged
    N = n_blocks if n_blocks is not None else k_pool.shape[0]
    Bg = batch if batch is not None else block_tbl.shape[0]
    pos = _positions(pos, q.shape[0], q.device)
    kind = pool_sharding_kind(mesh, N, Bg, data_axes, model_axis)
    if kind == "none":
        _whole("the pool", k_pool.shape[0], N)
        append_kv_paged(k_pool, k_new, pos, block_tbl)
        append_kv_paged(v_pool, v_new, pos, block_tbl)
        m, l, acc = _partial_attend_paged(q, k_pool, v_pool, block_tbl, pos,
                                          window, 0, block_kv)
        return _finish(q, l, acc), k_pool, v_pool

    sizes = mesh_sizes(mesh)
    msize = sizes.get(model_axis, 1)
    dnames, dsize = _data(mesh, data_axes)
    shard, n_shards = 0, 1
    if kind == "2d":
        _whole("the batch", q.shape[0], Bg // dsize)
        for a in dnames:
            shard = shard * sizes[a] + mesh.get_local_rank(a)
        n_shards = dsize
    else:
        _whole("the batch", q.shape[0], Bg)
    if model_axis in sizes:
        shard = shard * msize + mesh.get_local_rank(model_axis)
        n_shards *= msize
    Nl = N // n_shards
    _whole("the pool", k_pool.shape[0], Nl)
    start = shard * Nl
    append_kv_paged(k_pool, k_new, pos, block_tbl, start=start)
    append_kv_paged(v_pool, v_new, pos, block_tbl, start=start)
    m, l, acc = _partial_attend_paged(q, k_pool, v_pool, block_tbl, pos,
                                      window, start, block_kv)
    if msize > 1:
        topology = combine_topology(mesh, model_axis=model_axis,
                                    override=combine)
        l, acc = _combine(m, l, acc, mesh.get_group(model_axis), msize,
                          topology)
    return _finish(q, l, acc), k_pool, v_pool
