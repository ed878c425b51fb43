"""Tensor parallelism over a DeviceMesh: the collectives the model code
needs when each rank holds its piece of the parameters.

The JAX package lets GSPMD partition the model from the placements the
plan chose; the port runs explicit per-rank code instead.  Every rank
of a ``(data, model)`` mesh runs the same layer loop on the pieces
:func:`repro_torch.core.passes.lowering.param_pspecs` gave it, and the
model group's collectives restore what the whole computation would
give:

* a matrix split on its output dim (``wq``, ``wk``, ``wv``, an FFN's
  ``wi``, ``lm_head`` over the vocab) gives the rank's columns of the
  product; :func:`gather` joins them where the next op needs them all;
* a matrix split on its input dim (``wo``) gives a partial product;
  :func:`reduce_sum` adds the ranks' partials;
* a vocab-split embedding table looks up the rank's own ids and the
  ranks' rows add up (:func:`embed`).

Whether a leaf is split is read from its shape against the whole size
(the arch's, or the plan's padded one in :class:`~repro_torch.models
.lm.RunCfg`): the code adapts to the placement it is handed.  Partial
products are summed in fp32 and rounded once.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


class MeshCtx(NamedTuple):
    """This rank's place on the mesh: the model group (``msize`` ranks,
    this one ``mrank``) and the data group (``dsize``, ``drank``; a
    size-1 group where the mesh has no data axis)."""

    model_axis: str
    mgroup: object
    msize: int
    mrank: int
    dgroup: object
    dsize: int
    drank: int


def ctx(cfg) -> Optional[MeshCtx]:
    """The mesh context of a :class:`RunCfg`, ``None`` without one or
    without a mesh (then every helper here is the identity of one card).
    One data axis at most: several wait for ROADMAP item 10b."""
    mesh = cfg.mesh if cfg is not None else None
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    data = [a for a in cfg.data_axes if a in names]
    if len(data) > 1:
        raise NotImplementedError(
            f"serving over data axes {tuple(data)}: one data axis is "
            "ported; several wait for ROADMAP item 10b")
    ma = cfg.model_axis
    if ma in names:
        mgroup, msize, mrank = (mesh.get_group(ma), mesh.size(names.index(ma)),
                                mesh.get_local_rank(ma))
    else:
        mgroup, msize, mrank = None, 1, 0
    if data:
        d = data[0]
        dgroup, dsize, drank = (mesh.get_group(d), mesh.size(names.index(d)),
                                mesh.get_local_rank(d))
    else:
        dgroup, dsize, drank = None, 1, 0
    return MeshCtx(ma, mgroup, msize, mrank, dgroup, dsize, drank)


def reduce_sum(t: torch.Tensor, c: Optional[MeshCtx]) -> torch.Tensor:
    """The sum of every model rank's ``t`` (fp32, rounded once to
    ``t``'s dtype)."""
    if c is None or c.msize == 1:
        return t
    s = t.float()
    dist.all_reduce(s, group=c.mgroup)
    return s.to(t.dtype)


def gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` (``n`` of them) joined along
    ``dim`` in rank order."""
    if n == 1:
        return t
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_model(t: torch.Tensor, dim: int, c: Optional[MeshCtx]
                 ) -> torch.Tensor:
    return t if c is None else gather(t, dim, c.mgroup, c.msize)


def split(whole: int, local: int, c: Optional[MeshCtx]) -> bool:
    """Whether a dim of ``whole`` entries is split over the model ranks,
    given the rank holds ``local`` of them."""
    if c is None or local == whole:
        return False
    if local * c.msize != whole:
        raise ValueError(f"a dim of {whole} holds {local} here, not a "
                         f"1/{c.msize} piece")
    return True


def embed(table: torch.Tensor, tokens: torch.Tensor, vocab: int,
          c: Optional[MeshCtx]) -> torch.Tensor:
    """``table[tokens]`` for a ``(V, d)`` table whose rows may be split
    over the model ranks (the rank holds rows ``mrank * V_l`` on)."""
    ids = tokens.long()
    if not split(vocab, table.shape[0], c):
        return table[ids]
    lo = c.mrank * table.shape[0]
    loc = ids - lo
    mine = (loc >= 0) & (loc < table.shape[0])
    x = torch.where(mine[..., None], table[loc.clamp(0, table.shape[0] - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    return reduce_sum(x, c)


def head_range(whole: int, local: int, c: Optional[MeshCtx]
               ) -> Tuple[int, int]:
    """``(first, count)`` of the heads this rank holds of ``whole``
    (``(0, local)`` where they are not split)."""
    if not split(whole, local, c):
        return 0, local
    return c.mrank * local, local


def kv_for_heads(k: torch.Tensor, h0: int, hn: int, group: int
                 ) -> torch.Tensor:
    """The kv heads (dim 2 of ``k``, all ``K`` of them) that query heads
    ``[h0, h0 + hn)`` read at ``group`` query heads a kv head: a run of
    whole groups, or one kv head shared by a piece of a group."""
    if hn >= group:
        if h0 % group or hn % group:
            raise ValueError(f"query heads [{h0}, {h0 + hn}) split a GQA "
                             f"group of {group}")
        return k[:, :, h0 // group:(h0 + hn) // group]
    if group % hn or h0 // group != (h0 + hn - 1) // group:
        raise ValueError(f"query heads [{h0}, {h0 + hn}) straddle GQA "
                         f"groups of {group}")
    return k[:, :, h0 // group:h0 // group + 1]
