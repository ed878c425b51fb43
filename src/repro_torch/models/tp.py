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

Training differentiates through these collectives, so each is an
autograd function with its conjugate backward (the Megatron pairs):

* :func:`copy_in` is the identity whose backward all-reduces over the
  model group: it marks where a tensor every model rank computes alike
  enters work split over the ranks (a column-split matrix, a rank's
  heads, its experts), so each rank's share of the input gradient is
  summed;
* :func:`reduce_sum` all-reduces forward and passes the gradient
  through: what follows it is the same on every rank;
* :func:`gather` joins pieces forward and takes the rank's slice of the
  gradient back (what follows is the same on every rank; a caller that
  then cuts per-rank pieces puts :func:`copy_in` between);
* :func:`regroup_gated` hands a rank the gate and up columns of its FFN
  piece from the ``gate || up`` columns it computed (an all-gather each
  way);
* :func:`shared_sum` all-reduces forward and backward: a statistic
  summed over the ranks' pieces that every rank then applies to its own
  piece (the mamba2 gated norm's sum of squares over ``d_inner``), so
  each rank's share of its gradient comes from every rank.

Forwards are the serving code's values unchanged.  Several mesh axes
act together through :func:`repro_torch.dist.collectives.axes_groups`
(data-major, one collective an axis), so no flattened group is ever
created.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import all_gather, axes_groups, sum_over_


class MeshCtx(NamedTuple):
    """This rank's place on the mesh: the model group (``msize`` ranks,
    this one ``mrank``) and the data group, the mesh's data axes taken
    together as one linearised group (``dgroups``, the ``(group, size)``
    of each data axis, data-major as :func:`repro_torch.dist.collectives
    .axes_groups` orders them; ``dsize`` ranks, this one ``drank``, the
    index a spec entry ``("pod", "data")`` gives it; empty, 1 and 0
    where the mesh has no data axis); ``bgroups`` the ``(group, size)``
    of each mesh axis a training loss averages over
    (:attr:`RunCfg.batch_axes`, data-major; empty: this rank's tokens
    alone)."""

    model_axis: str
    mgroup: object
    msize: int
    mrank: int
    dgroups: Tuple
    dsize: int
    drank: int
    bgroups: Tuple = ()


def ctx(cfg) -> Optional[MeshCtx]:
    """The mesh context of a :class:`RunCfg`, ``None`` without one or
    without a mesh (then every helper here is the identity of one card).
    Several data axes (``("pod", "data", "model")``) act as one data
    group."""
    mesh = cfg.mesh if cfg is not None else None
    if mesh is None:
        return None
    from repro_torch.dist.sharding import shard_index
    names = tuple(mesh.mesh_dim_names)
    data = tuple(a for a in names if a in cfg.data_axes)
    ma = cfg.model_axis
    if ma in names:
        mgroup, msize, mrank = (mesh.get_group(ma), mesh.size(names.index(ma)),
                                mesh.get_local_rank(ma))
    else:
        mgroup, msize, mrank = None, 1, 0
    drank, dsize = shard_index(mesh, data) if data else (0, 1)
    return MeshCtx(ma, mgroup, msize, mrank, tuple(axes_groups(mesh, data)),
                   dsize, drank,
                   tuple(axes_groups(mesh, getattr(cfg, "batch_axes", ()))))


def _sum_fp32(t: torch.Tensor, groups) -> torch.Tensor:
    """The sum of ``t`` over ``groups`` (a ``(group, size)`` list), in
    fp32, rounded once to ``t``'s dtype, as a new tensor."""
    return sum_over_(t.clone(memory_format=torch.contiguous_format), groups)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, groups):
        ctx_.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        return _sum_fp32(g, ctx_.groups), None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, groups):
        return _sum_fp32(x, groups)

    @staticmethod
    def backward(ctx_, g):
        return g, None


class _SharedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, groups):
        ctx_.groups = groups
        return _sum_fp32(x, groups)

    @staticmethod
    def backward(ctx_, g):
        return _sum_fp32(g, ctx_.groups), None


def shared_sum(t: torch.Tensor, c: Optional[MeshCtx]) -> torch.Tensor:
    """The sum of every model rank's ``t`` (fp32, rounded once), which
    every rank then uses on its own piece: the gradient is summed over
    the ranks too."""
    if c is None or c.msize == 1:
        return t
    return _SharedSum.apply(t, [(c.mgroup, c.msize)])


def sum_over(t: torch.Tensor, groups) -> torch.Tensor:
    """The sum of ``t`` over ``groups`` (fp32, rounded once); the
    gradient passes through."""
    return _ReduceSum.apply(t, list(groups))


def copy_in(t: torch.Tensor, c: Optional[MeshCtx]) -> torch.Tensor:
    """``t`` as it is; its gradient summed over the model ranks (fp32,
    rounded once): where ``t``, the same on every model rank, enters
    work split over them."""
    if c is None or c.msize == 1:
        return t
    return _CopyIn.apply(t, [(c.mgroup, c.msize)])


def reduce_sum(t: torch.Tensor, c: Optional[MeshCtx]) -> torch.Tensor:
    """The sum of every model rank's ``t`` (fp32, rounded once to
    ``t``'s dtype); the gradient passes through."""
    if c is None or c.msize == 1:
        return t
    return sum_over(t, [(c.mgroup, c.msize)])


def batch_sum(t: torch.Tensor, c: Optional[MeshCtx]) -> torch.Tensor:
    """The sum of ``t`` over the ranks a training loss averages over
    (``c.bgroups``); the gradient passes through, so each rank's share
    of a statistic every rank then uses alike is differentiated once."""
    if c is None or not c.bgroups:
        return t
    return sum_over(t, c.bgroups)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, t, dim, groups, rank):
        ctx_.dim, ctx_.rank = dim, rank
        ctx_.n = 1
        for _, n in groups:
            ctx_.n *= n
        return all_gather(t, dim, groups)

    @staticmethod
    def backward(ctx_, g):
        w = g.shape[ctx_.dim] // ctx_.n
        return g.narrow(ctx_.dim, ctx_.rank * w, w).contiguous(), None, \
            None, None


def gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` (``n`` of them) joined along
    ``dim`` in rank order; the gradient's slice of this rank comes
    back."""
    if n == 1:
        return t
    return _Gather.apply(t, dim, [(group, n)], dist.get_rank(group))


def gather_data(t: torch.Tensor, dim: int, c: MeshCtx) -> torch.Tensor:
    """The data group's ``t`` joined along ``dim`` in its linearised
    (data-major) order; the gradient's slice of this rank comes back."""
    if c.dsize == 1:
        return t
    return _Gather.apply(t, dim, list(c.dgroups), c.drank)


class _RegroupGated(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, z, group, n, rank):
        ctx_.group, ctx_.n, ctx_.rank = group, n, rank
        whole = all_gather(z, -1, [(group, n)])
        ff = whole.shape[-1] // 2
        w = ff // n
        return torch.cat([whole[..., rank * w:(rank + 1) * w],
                          whole[..., ff + rank * w:ff + (rank + 1) * w]], -1)

    @staticmethod
    def backward(ctx_, g):
        n, rank = ctx_.n, ctx_.rank
        parts = all_gather(g, -1, [(ctx_.group, n)])    # (.., n * 2w)
        w = g.shape[-1] // 2
        pieces = parts.unflatten(-1, (n, 2, w))
        whole = torch.cat([pieces[..., 0, :].flatten(-2),
                           pieces[..., 1, :].flatten(-2)], -1)
        cols = whole.shape[-1] // n
        return whole[..., rank * cols:(rank + 1) * cols].contiguous(), \
            None, None, None


def regroup_gated(z: torch.Tensor, c: MeshCtx) -> torch.Tensor:
    """``z``, this rank's columns of a ``gate || up`` product (``2 ff /
    msize`` of them), as the rank's FFN piece ``gate[:, piece] ||
    up[:, piece]`` (``ff / msize`` each): every rank's columns gathered,
    the rank's two pieces kept; backward, every rank's piece gradients
    gathered and the rank's columns kept."""
    return _RegroupGated.apply(z, c.mgroup, c.msize, c.mrank)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, t, group):
        ctx_.group = group
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    @staticmethod
    def backward(ctx_, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx_.group)
        return out, None


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of equal splits on dim 0: chunk ``j`` goes
    to rank ``j``; its own adjoint, so the gradient takes the way back."""
    return _AllToAll.apply(t, group)


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
    whole groups, or one kv head shared by a piece of a group.  A range
    that cuts groups otherwise (13 of hymba-1.5b's 26 padded query heads
    over 13 kv heads) reads one kv head a query head: each kv head
    repeated for its group's heads, the range's rows kept (GQA group 1)."""
    if hn >= group and h0 % group == 0 and hn % group == 0:
        return k[:, :, h0 // group:(h0 + hn) // group]
    if hn < group and group % hn == 0 \
            and h0 // group == (h0 + hn - 1) // group:
        return k[:, :, h0 // group:h0 // group + 1]
    g0, g1 = h0 // group, (h0 + hn - 1) // group + 1
    return k[:, :, g0:g1].repeat_interleave(group, dim=2)[
        :, :, h0 - g0 * group:h0 - g0 * group + hn]


def flash_group(H: int, K: int, hn: int) -> int:
    """The GQA group a rank's flash call runs at when it holds ``hn`` of
    ``H`` query heads (a run from a multiple of ``hn``) over all ``K``
    kv heads, as :func:`kv_for_heads` hands them the kv heads: a run of
    whole groups keeps the group ``H / K``, a piece of one group runs at
    its length, any other range at 1 (one kv head a query head)."""
    group = H // K
    if hn >= group and hn % group == 0:
        return group
    if hn < group and group % hn == 0:
        return hn
    return 1


def rank_group(H: int, K: int, ways: int, split: bool) -> int:
    """The GQA group a rank's flash call runs at, ``H`` / ``K`` query /
    kv heads split over ``ways`` model ranks where the plan splits heads
    (``split``).  A count that divides ``ways`` is cut into whole heads;
    any other stays whole on every rank (its projection's columns are
    gathered whole, :func:`repro_torch.models.lm._qkv`).  Query heads
    over their own kv heads, or whole, keep ``H / K``; a rank's query
    heads over every kv head run at :func:`flash_group`'s group."""
    hl = H // ways if split and ways > 1 and H % ways == 0 else H
    kv_split = split and ways > 1 and K % ways == 0
    return H // K if hl == H or kv_split else flash_group(H, K, hl)
